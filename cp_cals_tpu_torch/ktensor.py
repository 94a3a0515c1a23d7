"""Ktensor: the CP model (factor matrices + column weights) on torch tensors.

Port of ``cp_cals_tpu/ktensor.py``. Shapes are the JAX package's: factors
``[..., I_n, R]``, lam ``[..., R]``, with any leading batch dims. Padded
rank columns are exactly zero with zero weight, which keeps them inert in
every kernel.
"""

from __future__ import annotations

import string
from typing import NamedTuple, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


class Ktensor(NamedTuple):
    """CP model: ``X ~= sum_r lam[r] * outer(factors[0][:,r], ...)``."""

    factors: tuple
    lam: Tensor

    @property
    def rank(self) -> int:
        return self.lam.shape[-1]

    @property
    def n_modes(self) -> int:
        return len(self.factors)

    @property
    def modes(self) -> tuple[int, ...]:
        return tuple(f.shape[-2] for f in self.factors)


def random_ktensor_host(
    rng, modes: Sequence[int], rank: int, dtype=np.float32
) -> Ktensor:
    """Host-side (NumPy) random Ktensor: uniform(-1, 1) factors, then full
    normalization. The same draws and arithmetic as the JAX package's
    ``random_ktensor_host``, so one seed gives one model in both packages.

    rng: a ``numpy.random.Generator`` (or an int seed).
    """
    if isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(int(rng))
    dtype = np.dtype(dtype)
    factors = []
    lam = np.ones(rank, dtype)
    for m in modes:
        f = rng.uniform(-1.0, 1.0, size=(m, rank)).astype(dtype)
        coeff = np.linalg.norm(f, axis=0)
        safe = np.where(coeff != 0, coeff, 1.0)
        factors.append(f / safe)
        lam = lam * coeff.astype(dtype)
    return Ktensor(tuple(factors), lam)


def normalize_full(kt: Ktensor) -> Ktensor:
    """Per-column L2 normalization of every factor; weights go into lam.
    Zero (padded) columns stay zero with lam = 0."""
    lam = torch.ones_like(kt.lam)
    new_factors = []
    for f in kt.factors:
        coeff = torch.linalg.vector_norm(f, dim=-2)
        safe = torch.where(coeff != 0, coeff, torch.ones_like(coeff))
        new_factors.append(f / safe[..., None, :])
        lam = lam * coeff
    return Ktensor(tuple(new_factors), lam)


def _signed_max(f: Tensor) -> Tensor:
    """Signed entry of largest magnitude per column; a tie |max| == |min|
    picks the max (``mx >= -mn``, as the JAX package does)."""
    mx = torch.amax(f, dim=-2)
    mn = torch.amin(f, dim=-2)
    return torch.where(mx >= -mn, mx, mn)


def _is_first(iteration, like: Tensor) -> Tensor:
    it = torch.as_tensor(iteration, device=like.device)
    return (it == 1)[..., None]


def normalize_mode(kt: Ktensor, mode: int, iteration) -> Ktensor:
    """Normalize one factor: L2 column norm at iteration 1, the signed max
    after. Columns whose new weight is zero are not scaled."""
    f = kt.factors[mode]
    l2 = torch.linalg.vector_norm(f, dim=-2)
    lam_new = torch.where(_is_first(iteration, f), l2, _signed_max(f))
    safe = torch.where(lam_new != 0, lam_new, torch.ones_like(lam_new))
    f_new = f / safe[..., None, :]
    factors = kt.factors[:mode] + (f_new,) + kt.factors[mode + 1 :]
    return Ktensor(factors, lam_new.to(kt.lam.dtype))


def normalize_factor_fused(f: Tensor, iteration) -> tuple[Tensor, Tensor, Tensor]:
    """``normalize_mode`` + the normalized factor's gramian in one pass:
    iteration-1 L2 norms come from the raw gramian's diagonal, and the
    normalized gramian is a rescale of the raw one.

    Returns (normalized factor, new lam, gramian of the normalized factor).
    """
    from .ops.gramians import gramian

    gm_raw = gramian(f)
    l2 = torch.sqrt(torch.abs(torch.diagonal(gm_raw, dim1=-2, dim2=-1)))
    lam_new = torch.where(_is_first(iteration, f), l2, _signed_max(f)).to(f.dtype)
    safe = torch.where(lam_new != 0, lam_new, torch.ones_like(lam_new))
    f_new = f / safe[..., None, :]
    gm = gm_raw / (safe[..., :, None] * safe[..., None, :])
    return f_new, lam_new, gm


def denormalize(kt: Ktensor) -> Ktensor:
    """Fold lam into factor 0."""
    f0 = kt.factors[0] * kt.lam[..., None, :]
    return Ktensor((f0,) + tuple(kt.factors[1:]), torch.ones_like(kt.lam))


def to_tensor(kt: Ktensor) -> Tensor:
    """Dense reconstruction ``X[i0..iN] = sum_r lam[r] prod_n U_n[i_n, r]``
    (unbatched models)."""
    idx = string.ascii_lowercase[: kt.n_modes]
    expr = ",".join(f"{c}z" for c in idx) + ",z->" + idx
    return torch.einsum(expr, *kt.factors, kt.lam)


def scale_jk_rows(f0: Tensor, fiber, value: float = 0.0) -> Tensor:
    """Scale row ``fiber`` of a mode-0 factor (the jackknife left-out
    sample); ``fiber < 0`` means "not a jackknife model" (no-op)."""
    rows = f0.shape[-2]
    fiber = torch.as_tensor(fiber, device=f0.device)
    row_ids = torch.arange(rows, device=f0.device)
    hit = (row_ids == fiber[..., None]) & (fiber >= 0)[..., None]
    return torch.where(hit[..., None], f0 * value, f0)


def pad_rank(kt: Ktensor, target_rank: int) -> Ktensor:
    """Zero-pad factor columns and lam up to ``target_rank``."""
    r = kt.rank
    if r == target_rank:
        return kt
    if r > target_rank:
        raise ValueError(f"rank {r} > bucket rank {target_rank}")
    pad = target_rank - r
    factors = tuple(torch.nn.functional.pad(f, (0, pad)) for f in kt.factors)
    return Ktensor(factors, torch.nn.functional.pad(kt.lam, (0, pad)))


def truncate_rank(kt: Ktensor, rank: int) -> Ktensor:
    """Drop padded columns (inverse of ``pad_rank``)."""
    return Ktensor(tuple(f[..., :rank] for f in kt.factors), kt.lam[..., :rank])
