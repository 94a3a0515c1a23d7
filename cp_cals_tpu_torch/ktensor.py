"""Ktensor: the CP model (factor matrices + column weights) on torch tensors.

Port of ``cp_cals_tpu/ktensor.py``. Shapes are the JAX package's: factors
``[..., I_n, R]``, lam ``[..., R]``, with any leading batch dims. Padded
rank columns are exactly zero with zero weight, which keeps them inert in
every kernel.

``RandomKtensorSpec`` queue entries are generated on the device from
their seeds with the JAX package's threefry keys (``prng.py``): the
uniform draws equal JAX's bit for bit, the normalization is this
module's own (``spec_block``).
"""

from __future__ import annotations

import string
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .prng import fold_in, prng_key, split, uniform

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


class RandomKtensorSpec(NamedTuple):
    """A queue entry that says "random initial guess, generated on the
    device" (the JAX package's ``RandomKtensorSpec``, same fields). Column
    ``j`` of mode ``n`` is ``uniform(fold_in(fold_in(PRNGKey(seed), n), j),
    (I_n,), -1, 1)``, then every column is normalized: the same model in
    whichever rank bucket the engine packs it. ``dtype`` None means
    float32."""

    modes: tuple
    rank: int
    seed: int
    dtype: str | None = None

    @property
    def n_modes(self) -> int:
        return len(self.modes)


_FLOAT_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def float_dtype(dtype) -> torch.dtype:
    """float32 or float64 as a torch dtype, from a name, a NumPy or torch
    dtype, or None (float32: the port has no x64 switch)."""
    if dtype is None:
        return torch.float32
    name = str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    if name not in _FLOAT_DTYPES:
        raise ValueError(f"dtype {dtype!r}: float32 or float64 expected")
    return _FLOAT_DTYPES[name]


def _spec_columns(key: Tensor, mode_idx, m: int, r: int, dtype) -> Tensor:
    """``[..., r, m]``: the r columns of mode ``mode_idx`` as rows, one
    fold_in-derived key per column (``key`` ``[..., 2]``), so the values do
    not depend on how many columns are drawn. A 1-D tensor of mode indices
    gives ``[N, ..., r, m]``: every mode in one draw, the first I_n entries
    of row n being mode n's (each entry is the hash of its own index)."""
    d = torch.as_tensor(mode_idx, dtype=torch.int64, device=key.device)
    kn = fold_in(key, d.reshape(d.shape + (1,) * (key.ndim - 1)))
    cols = torch.arange(r, dtype=torch.int64, device=key.device)
    return uniform(fold_in(kn[..., None, :], cols), (m,), dtype, -1.0, 1.0)


def _row_norms(rows: Tensor) -> Tensor:
    """L2 norm of each row of ``[..., m]``, summed by halving (zero-padded to
    a power of two): elementwise steps only, so a row's norm has the same
    bits in any batch, on any device."""
    sq = rows * rows
    m = sq.shape[-1]
    sq = torch.nn.functional.pad(sq, (0, (1 << max(m - 1, 0).bit_length()) - m))
    while sq.shape[-1] > 1:
        h = sq.shape[-1] // 2
        sq = sq[..., :h] + sq[..., h:]
    return torch.sqrt(sq[..., 0])


def spec_block(seeds: Tensor, rank_mask: Tensor, modes: Sequence[int], dtype) -> Ktensor:
    """A batch of spec models on ``seeds``' device: factors ``[B, I_n, R]``,
    lam ``[B, R]``, R = ``rank_mask.shape[-1]``. Columns outside
    ``rank_mask`` are zeroed before the normalization, so they stay zero
    with lam = 0 (inert bucket padding)."""
    r = rank_mask.shape[-1]
    # One draw for all modes (about 500 elementwise kernels in place of
    # about 500 per mode: the build is launch-bound), cut to each mode's length.
    draws = _spec_columns(prng_key(seeds), torch.arange(len(modes)), max(modes), r, dtype)
    lam = torch.ones(rank_mask.shape, dtype=dtype, device=seeds.device)
    factors = []
    for n, m in enumerate(modes):
        cols = draws[n, ..., :m]
        cols = torch.where(rank_mask[..., None], cols, torch.zeros((), dtype=dtype, device=cols.device))
        coeff = _row_norms(cols)
        safe = torch.where(coeff != 0, coeff, torch.ones_like(coeff))
        factors.append((cols / safe[..., None]).transpose(-1, -2).contiguous())
        lam = lam * coeff
    return Ktensor(tuple(factors), lam)


def spec_to_ktensor(spec: RandomKtensorSpec, device=None) -> Ktensor:
    """Materialize a ``RandomKtensorSpec`` on ``device`` (None: the card),
    bit for bit the model the engine generates for it."""
    from .device import resolve_device

    dev = resolve_device(device)
    seeds = torch.tensor([int(spec.seed)], dtype=torch.int64, device=dev)
    mask = torch.ones((1, int(spec.rank)), dtype=torch.bool, device=dev)
    kt = spec_block(seeds, mask, spec.modes, float_dtype(spec.dtype))
    return Ktensor(tuple(f[0] for f in kt.factors), kt.lam[0])


def random_ktensor(key: Tensor, modes: Sequence[int], rank: int, dtype=torch.float32) -> Ktensor:
    """Uniform(-1, 1) factors from ``split(key, len(modes))``, then full
    normalization (the JAX package's ``random_ktensor``; ``key`` a
    ``prng.prng_key``, on the device the factors are drawn on)."""
    keys = split(key, len(modes))
    factors = tuple(uniform(k, (int(m), rank), dtype, -1.0, 1.0) for k, m in zip(keys, modes))
    return normalize_full(Ktensor(factors, torch.ones(rank, dtype=dtype, device=key.device)))


def to_host(kt: Ktensor) -> Ktensor:
    """A Ktensor of host NumPy arrays."""

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    return Ktensor(tuple(host(f) for f in kt.factors), host(kt.lam))


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


def normalize_full(kt: Ktensor, tp=None) -> Ktensor:
    """Per-column L2 normalization of every factor; weights go into lam.
    Zero (padded) columns stay zero with lam = 0. ``tp`` (a
    ``parallel.sharding.TpRows``, or None) holds factor 0's rows split over
    ranks: its squared column norms are summed over them."""
    lam = torch.ones_like(kt.lam)
    new_factors = []
    for n, f in enumerate(kt.factors):
        if tp is not None and n == 0:
            coeff = torch.sqrt(tp.sum(torch.sum(f * f, dim=-2)))
        else:
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


def _cat(parts: Sequence, axis: int):
    """Concatenate torch tensors (``torch.cat``) or host arrays (NumPy)."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts), dim=axis)
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)


def set_jk_fiber(kt: Ktensor, fiber, value: float = 0.0) -> Ktensor:
    """Scale row ``fiber`` of the mode-0 factor (the jackknife left-out
    sample; reference ``Ktensor::set_jk_fiber``, the JAX package's
    ``set_jk_fiber``): ``scale_jk_rows`` on factor 0, one fiber per model
    for batched models, a fiber below 0 a no-op. A host (NumPy) model
    stays on the host."""
    f0 = kt.factors[0]
    if isinstance(f0, torch.Tensor):
        f0_new = scale_jk_rows(f0, fiber, value)
    else:
        f0_new = scale_jk_rows(torch.from_numpy(np.asarray(f0)), np.asarray(fiber), value).numpy()
    return Ktensor((f0_new,) + tuple(kt.factors[1:]), kt.lam)


def jk_to_regular(kt: Ktensor, fiber: int) -> Ktensor:
    """Drop row ``fiber`` of factor 0: the (I0-1)-row model of a jackknife
    replicate (reference ``Ktensor::to_regular``, the JAX package's
    ``jk_to_regular``), leading batch dims kept. Takes torch tensors or the
    host (NumPy) models the jackknife drivers return, and exports them."""
    f0 = kt.factors[0]
    f0_new = _cat([f0[..., :fiber, :], f0[..., fiber + 1 :, :]], -2)
    return Ktensor((f0_new,) + tuple(kt.factors[1:]), kt.lam)


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


def concatenate_ktensors(kts: Sequence[Ktensor]) -> Ktensor:
    """Column-concatenate same-shape models into one wide Ktensor
    (reference ``utils.cpp:18-38``, the JAX package's
    ``concatenate_ktensors``): factors and lam along the last axis."""
    factors = tuple(_cat([kt.factors[m] for kt in kts], -1) for m in range(kts[0].n_modes))
    return Ktensor(factors, _cat([kt.lam for kt in kts], -1))
