"""Approximation error (port of ``cp_cals_tpu/ops/error.py``).

``fast_error`` is the FastALS formula err^2 = |X|^2 + lam^T H lam
- 2 * sum_j lam_j <U_N[:,j], G_last[:,j]>, clamped at 0. Its three terms
are O(|X|^2) while the result is small near convergence. A float64 state
takes a plain float64 reduction. A float32 state takes the compensated
path: every product enters as an exact (hi, lo) pair and the sums run in
double-float arithmetic. PyTorch runs each elementwise op as its own
kernel, so no product here is contracted into an FMA, which the Dekker
split of ``_two_prod`` relies on.
"""

from __future__ import annotations

import torch

from ..ktensor import Ktensor, denormalize, to_tensor


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _fast_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _split_const(dtype) -> float:
    # 2^ceil(p/2) + 1 with p = mantissa bits: 4097 for f32, 2^27+1 for f64.
    return 4097.0 if dtype == torch.float32 else 134217729.0


def _two_prod(a, b):
    """Dekker TwoProd (FMA-free): p + e == a * b exactly."""
    c = _split_const(a.dtype)
    ca = c * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = c * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    p = a * b
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _df_add(x, y):
    s, e = _two_sum(x[0], y[0])
    return _fast_two_sum(s, e + x[1] + y[1])


def _df_sum(hi: torch.Tensor, lo: torch.Tensor):
    """Tree-fold a double-float array over its last axis (pairwise, padded
    to a power of two)."""
    n = hi.shape[-1]
    p = 1
    while p < n:
        p *= 2
    hi = torch.nn.functional.pad(hi, (0, p - n))
    lo = torch.nn.functional.pad(lo, (0, p - n))
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        hi, lo = _df_add((hi[..., :h], lo[..., :h]), (hi[..., h:], lo[..., h:]))
    return hi[..., 0], lo[..., 0]


def _df_term2(lam, gh):
    """term2 = sum_{i,j} lam_i lam_j H_ij as a double-float value."""
    ll_hi, ll_lo = _two_prod(
        lam[..., :, None].expand(gh.shape), lam[..., None, :].expand(gh.shape)
    )
    q_hi, q_lo = _two_prod(ll_hi, gh)
    return _df_sum(
        q_hi.reshape(*q_hi.shape[:-2], -1),
        (q_lo + ll_lo * gh).reshape(*q_hi.shape[:-2], -1),
    )


def _df_finish(x_norm, t2, t3):
    xn2 = _two_prod(x_norm, x_norm)
    acc = _df_add(xn2, t2)
    acc = _df_add(acc, (-2.0 * t3[0], -2.0 * t3[1]))
    return torch.sqrt(torch.clamp(acc[0] + acc[1], min=0.0))


def _as_tensor(v, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device).to(dtype)


def fast_error(x_norm, lam, last_factor, last_mttkrp, gramian_hadamard):
    """Batched FastALS error.

    x_norm [...]; lam [..., R]; last_factor, last_mttkrp [..., I_N, R];
    gramian_hadamard [..., R, R] (product of ALL gramians).
    """
    dtype = lam.dtype
    if dtype == torch.float64:
        term2 = torch.einsum("...i,...j,...ij->...", lam, lam, gramian_hadamard)
        term3 = torch.einsum("...j,...ij,...ij->...", lam, last_factor, last_mttkrp)
        xn = _as_tensor(x_norm, lam, dtype)
        return torch.sqrt(torch.clamp(xn * xn + term2 - 2.0 * term3, min=0.0))
    xn = _as_tensor(x_norm, lam, dtype)
    p1, e1 = _two_prod(last_factor, last_mttkrp)
    lam_b = lam[..., None, :]
    p2, e2 = _two_prod(p1, lam_b.expand(p1.shape))
    t3 = _df_sum(
        p2.reshape(*p2.shape[:-2], -1),
        (e2 + e1 * lam_b).reshape(*p2.shape[:-2], -1),
    )
    return _df_finish(xn, _df_term2(lam, gramian_hadamard), t3)


def fast_error_from_cols(x_norm, lam, t3_hi, t3_lo, gramian_hadamard):
    """FastALS error from the term-3 column sums sum_i U_N[i,j] G[i,j] that
    the fused epilogue emits as double-float (hi, lo) pairs [..., R]."""
    dtype = lam.dtype
    if dtype == torch.float64:
        t3 = torch.sum(lam * (t3_hi + t3_lo), dim=-1)
        term2 = torch.einsum("...i,...j,...ij->...", lam, lam, gramian_hadamard)
        xn = _as_tensor(x_norm, lam, dtype)
        return torch.sqrt(torch.clamp(xn * xn + term2 - 2.0 * t3, min=0.0))
    xn = _as_tensor(x_norm, lam, dtype)
    p, e = _two_prod(lam, t3_hi)
    t3 = _df_sum(p, e + lam * t3_lo)
    return _df_finish(xn, _df_term2(lam, gramian_hadamard), t3)


def reconstruction_error(x: torch.Tensor, kt: Ktensor) -> torch.Tensor:
    """|X - full(kt)| by dense reconstruction (test oracle)."""
    return torch.linalg.vector_norm((x - to_tensor(denormalize(kt))).reshape(-1))
