"""The jackknife's reference: every leave-one-out replicate of a fitted
model refitted to convergence by plain float64 ALS (``als.sweeps``), the
column order that matches a replicate to the fitted model (the linear
assignment that maximizes the summed inner products of the columns of
modes 1 and 2), and the jackknife's standard error of every factor entry.

Plain PyTorch and SciPy; imports nothing of the measured program.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from . import als


def replicates(p: als.Problem, base, rows, tol: float, max_sweeps: int, min_sweeps: int = 0):
    """The replicates of ``base`` (three ``[I_n, R]`` factors, any scale)
    that leave out mode-0 rows ``rows``, each from ``base``: ``min_sweeps``
    sweeps, then more until no replicate's fit moves by ``tol`` in a sweep
    (the fit moves at second order near its optimum, so the first sweeps
    may already stop it while the factors still move). Returns (factors,
    lam, fit, sweeps run)."""
    n = len(rows)
    rows = torch.as_tensor(rows, device=base[0].device)
    start = [u.unsqueeze(0).expand(n, *u.shape).contiguous() for u in base]
    f, _, _, first = als.sweeps(p, start, min_sweeps, rows=rows)
    f, lam, fit, more = als.sweeps(p, f, max_sweeps - first, rows=rows, tol=tol)
    return f, lam, fit, first + more


def lsap_orders(base, factors) -> np.ndarray:
    """Per replicate, the column order that best matches the normalized
    ``base`` (the largest sum over modes 1.. of ``base_n^T U_n``), [B, R]."""
    base = [als.normalize(u.unsqueeze(0))[0][0] for u in base]
    score = sum(b.T @ u for b, u in zip(base[1:], factors[1:]))  # [B, R, R] by broadcasting
    out = []
    for m in score.cpu().numpy():
        _, cols = linear_sum_assignment(-m)
        out.append(cols)
    return np.stack(out)


def aligned(base, factors, order=None):
    """Replicates (three ``[B, I_n, R]``) in the base's terms: columns in
    ``order`` (``[B, R]``, None to keep them), each of unit norm, each with
    the sign of its inner product with the base's column."""
    out = []
    for b, u in zip(base, factors):
        if order is not None:
            u = torch.gather(u, 2, torch.as_tensor(order, device=u.device)[:, None, :].expand(-1, u.shape[1], -1))
        u, _ = als.normalize(u)
        s = torch.sign((u * b.to(u.dtype)).sum(1, keepdim=True))
        out.append(u * torch.where(s == 0, torch.ones_like(s), s))
    return out


def standard_errors(factors):
    """The jackknife's standard error of every entry of each mode's factor,
    ``[I_n, R]``, over the replicates (three ``[B, I_n, R]``, aligned):
    ``sqrt((k - 1) / k * sum (u - mean)^2)`` over the k replicates that
    hold the entry. Replicate b leaves out row b of mode 0, which it does
    not hold."""
    n = factors[0].shape[0]
    out = []
    for m, u in enumerate(factors):
        w = torch.ones(n, u.shape[1], 1, dtype=u.dtype, device=u.device)
        if m == 0:
            w[torch.arange(n), torch.arange(n)] = 0
        u = torch.where(w > 0, u, torch.zeros_like(u))
        k = w.sum(0)
        mean = u.sum(0) / k
        out.append(torch.sqrt((k - 1) / k * (w * (u - mean) ** 2).sum(0)))
    return out
