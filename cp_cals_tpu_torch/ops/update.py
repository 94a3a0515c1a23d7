"""Unconstrained factor update (port of ``cp_cals_tpu/ops/update.py:31-114``).

These form the unfused ``epilogue="xla"`` path, and they are the plain
building blocks of the fused epilogue kernels' plain versions
(``ops/fused_epilogue.py``).
"""

from __future__ import annotations

import torch

from .spd_inverse import spd_inverse


def padded_hadamard(h: torch.Tensor, rank_mask: torch.Tensor) -> torch.Tensor:
    """Zero padded rows/columns and put 1 on their diagonal, so the system
    stays SPD and padded solutions stay zero.

    h: [..., R, R]; rank_mask: [..., R] bool, True for real columns.
    """
    m = rank_mask.to(h.dtype)
    pair = m[..., :, None] * m[..., None, :]
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return h * pair + eye * (1.0 - m[..., None, :])


def cholesky_inverse(h: torch.Tensor) -> torch.Tensor:
    """H^-1 of a batched SPD matrix via Cholesky and a triangular solve."""
    chol = torch.linalg.cholesky(h)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device).expand(h.shape)
    l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.matmul(l_inv.transpose(-1, -2), l_inv)


def gj_inverse(h: torch.Tensor) -> torch.Tensor:
    """H^-1 of a batched SPD matrix by unpivoted Gauss-Jordan elimination
    (SPD pivots are positive Schur-complement diagonals)."""
    r = h.shape[-1]
    a = h
    inv = torch.eye(r, dtype=h.dtype, device=h.device).expand(h.shape)
    rows = torch.arange(r, device=h.device)[:, None]
    for j in range(r):
        d = a[..., j : j + 1, j : j + 1]
        arow = a[..., j : j + 1, :] / d
        irow = inv[..., j : j + 1, :] / d
        colj = a[..., :, j : j + 1]
        is_j = rows == j
        a = torch.where(is_j, arow, a - colj * arow)
        inv = torch.where(is_j, irow, inv - colj * irow)
    return inv


def update_factor_unconstrained(
    g: torch.Tensor, h: torch.Tensor, solve: str = "gj"
) -> torch.Tensor:
    """Solve U H = G for U: U = G H^-1, batched.

    g: [..., I, R] MTTKRP result; h: [..., R, R] SPD normal matrix.
    solve: "gj" (unpivoted Gauss-Jordan), "chol", or "pallas" (the batched
    SPD-inverse kernel, ``ops/spd_inverse.py``, on a [B, R, R] batch; the
    name is the JAX package's, and other shapes take ``gj_inverse``).
    """
    if solve not in ("gj", "chol", "pallas"):
        raise ValueError(f"solve={solve!r}")
    if solve == "pallas" and h.ndim == 3:
        h_inv = spd_inverse(h)
    elif solve == "chol":
        h_inv = cholesky_inverse(h)
    else:
        h_inv = gj_inverse(h)
    return torch.matmul(g, h_inv)
