"""A deliberately independent pure-NumPy CP-ALS (the port's own copy of
the JAX repo's ``tests/external_cp_als.py``; bench_external_cpd's NumPy
contender).

The analog of the reference's TensorToolbox cross-validation
(``matlab/matlab_src/TTB_vs_CALS.m`` of the reference): an external
oracle that shares no code, no contraction strategy and no solver with
either package. Textbook ALS (Kolda & Bader 2009, Alg. 2): explicit mode-n
unfoldings, explicit column-wise Khatri-Rao products, pseudo-inverse
normal-equation solves, and the reference's per-mode normalization
schedule (iteration 1: L2 column norms; later: the signed max element,
ktensor.cpp:66-83).
"""

from __future__ import annotations

import numpy as np


def unfold(x: np.ndarray, mode: int) -> np.ndarray:
    """Mode-n unfolding with remaining modes in ascending order."""
    order = [mode] + [m for m in range(x.ndim) if m != mode]
    return np.transpose(x, order).reshape(x.shape[mode], -1)


def khatri_rao(mats: list[np.ndarray]) -> np.ndarray:
    """Column-wise Kronecker of the given matrices, first matrix slowest."""
    r = mats[0].shape[1]
    out = mats[0]
    for m in mats[1:]:
        out = np.einsum("ir,jr->ijr", out, m).reshape(-1, r)
    return out


def cp_als_numpy(
    x: np.ndarray,
    factors0: list[np.ndarray],
    lam0: np.ndarray,
    n_iter: int,
):
    """Run exactly n_iter textbook ALS iterations from the given init.

    Returns (factors, lam). Normalization matches the reference's schedule
    so trajectories are comparable at matched iteration counts.
    """
    factors = [np.array(f, dtype=np.float64) for f in factors0]
    lam = np.array(lam0, dtype=np.float64)
    # Fold lam into the first factor, as solvers do at intake.
    n_modes = x.ndim

    for it in range(1, n_iter + 1):
        for n in range(n_modes):
            others = [m for m in range(n_modes) if m != n]
            krp = khatri_rao([factors[m] for m in others])
            g = unfold(x, n) @ krp  # MTTKRP
            h = np.ones((lam.size, lam.size))
            for m in others:
                h = h * (factors[m].T @ factors[m])
            u = g @ np.linalg.pinv(h)  # independent solve path
            # Per-mode normalization (reference ktensor.cpp:66-83):
            # iteration 1 uses L2 column norms, later iterations the SIGNED
            # max-magnitude entry (tie between |max| and |min| -> max).
            # lambda is REPLACED by the just-normalized mode's norms.
            if it == 1:
                norms = np.linalg.norm(u, axis=0)
            else:
                mx, mn = u.max(axis=0), u.min(axis=0)
                norms = np.where(mx >= -mn, mx, mn)
            safe = np.where(norms == 0, 1.0, norms)
            factors[n] = u / safe
            lam = norms
    return factors, lam


def reconstruct(factors: list[np.ndarray], lam: np.ndarray) -> np.ndarray:
    r = lam.size
    out = None
    krp = khatri_rao(factors[1:])
    m0 = factors[0] * lam
    out = m0 @ krp.T
    shape = [f.shape[0] for f in factors]
    return out.reshape(shape)
