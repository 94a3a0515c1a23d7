"""Plain alternating least squares for dense 3-way tensors: the benchmark's
reference for the model-selection and jackknife cells.

Plain PyTorch, batched over models of one rank, in the dtype of the tensor
it is given: float64 for the comparison; float32 with every product's
operands rounded to TF32 (``tf32``) for the precision control. It imports nothing
of the measured program and takes nothing the program made: the benchmark
hands it the tensor and the initial models it handed the program.

One sweep updates modes 0, 1 and 2 in turn, each by the normal equations
``U_n = G_n H_n^-1`` with ``G_n`` the MTTKRP and ``H_n`` the Hadamard
product of the other modes' gramians, and normalizes the columns (L2 norm,
weights into ``lam``). A jackknife replicate leaves out row ``f`` of mode 0
by zeroing that row after every mode-0 update, which is ALS on the tensor
without its slice ``f``. The fit is ``1 - |X - model| / |X|`` with the full
tensor's norm in the denominator and, for a replicate, the left-out
tensor's norm inside the error, in the FastALS form (the norm, the
model's norm from the gramians, and the inner product from the last
mode's MTTKRP).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def mttkrp(x: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """``G[b, i_mode, r]`` of a batch of models (``factors``: three
    ``[B, I_n, R]``) against the 3-way tensor ``x``."""
    if x.ndim != 3:
        raise ValueError(f"the reference takes 3-way tensors, got {x.ndim} modes")
    i, j, k = x.shape
    a, b, c = factors
    nb, _, r = a.shape
    if mode in (0, 1):  # T = X x_2 C, shared by modes 0 and 1
        t = (x.reshape(i * j, k) @ c.permute(1, 0, 2).reshape(k, nb * r)).reshape(i, j, nb, r)
        if mode == 0:
            return torch.einsum("ijbr,bjr->bir", t, b)
        return torch.einsum("ijbr,bir->bjr", t, a)
    s = (a.permute(0, 2, 1).reshape(nb * r, i) @ x.reshape(i, j * k)).reshape(nb, r, j, k)
    return torch.einsum("brjk,bjr->bkr", s, b)


def gram(u: torch.Tensor) -> torch.Tensor:
    return u.transpose(1, 2) @ u


def normalize(u: torch.Tensor):
    """Columns to unit L2 norm; returns (u, norms). A zero column stays zero."""
    norms = torch.linalg.vector_norm(u, dim=1)
    return u / torch.where(norms > 0, norms, torch.ones_like(norms))[:, None, :], norms


def fit_from_mttkrp(x_norm_sq: torch.Tensor, x_norm: float, factors, lam, g_last) -> torch.Tensor:
    """FastALS fit of each model: ``err^2 = |X|^2 - 2 <X, model> + |model|^2``
    with ``<X, model>`` from the last mode's MTTKRP ``g_last`` (taken at the
    model's other factors). ``x_norm_sq`` per model (the left-out norm of a
    replicate), ``x_norm`` the full tensor's."""
    h = torch.ones_like(lam[:, :, None] * lam[:, None, :])
    for u in factors:
        h = h * gram(u)
    model_sq = torch.einsum("br,brs,bs->b", lam, h, lam)
    inner = torch.einsum("bir,bir,br->b", g_last, factors[-1], lam)
    err_sq = torch.clamp(x_norm_sq - 2 * inner + model_sq, min=0)
    return 1 - torch.sqrt(err_sq) / x_norm


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest (ties
    away from zero), as the tensor cores round a TF32 product's operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Problem:
    """The tensor, its norms and, for the jackknife, the left-out norms.
    ``operand`` rounds every product's operands (``tf32`` for the control;
    None: none)."""

    def __init__(self, x: torch.Tensor, operand=None):
        self.rnd = operand or (lambda t: t)
        self.x = self.rnd(x)
        self.norm_sq = torch.sum(x * x)
        self.norm = float(torch.sqrt(self.norm_sq))
        self.row_sq = torch.sum(x * x, dim=(1, 2))

    def norms_sq(self, n_models: int, rows=None) -> torch.Tensor:
        """``|X|^2`` per model, or ``|X without row f|^2`` for replicates."""
        if rows is None:
            return self.norm_sq.expand(n_models)
        return self.norm_sq - self.row_sq[rows]


def _zero_rows(u: torch.Tensor, rows) -> torch.Tensor:
    if rows is None:
        return u
    u = u.clone()
    u[torch.arange(u.shape[0], device=u.device), rows] = 0
    return u


def sweeps(p: Problem, factors, n: int, rows=None, tol: float = 0.0):
    """``n`` ALS sweeps of a batch of models of one rank from ``factors``
    (three ``[B, I_n, R]``); with ``tol`` > 0 the sweeps stop once no model's
    fit moved by ``tol`` or more in the last sweep. ``rows``: each model's
    left-out row of mode 0 (a jackknife replicate), or None.

    Returns (factors normalized, lam, fit, sweeps run)."""
    f = [u.clone() for u in factors]
    f[0] = _zero_rows(f[0], rows)
    rnd = p.rnd
    grams = [gram(rnd(u)) for u in f]
    x_norm_sq = p.norms_sq(f[0].shape[0], rows)
    fit, lam, done = None, None, 0
    for _ in range(n):
        for mode in range(3):
            g = mttkrp(p.x, [rnd(u) for u in f], mode)
            h = torch.ones_like(grams[0])
            for m in range(3):
                if m != mode:
                    h = h * grams[m]
            u = torch.linalg.solve(h, g.transpose(1, 2)).transpose(1, 2)
            if mode == 0:
                u = _zero_rows(u, rows)
            f[mode], lam = normalize(u)
            grams[mode] = gram(rnd(f[mode]))
        new = fit_from_mttkrp(x_norm_sq, p.norm, [rnd(u) for u in f], lam, g)
        done += 1
        if tol > 0 and fit is not None and float(torch.max(torch.abs(new - fit))) < tol:
            fit = new
            break
        fit = new
    return f, lam, fit, done


def model_fit(p: Problem, factors, lam, rows=None) -> torch.Tensor:
    """The fit of given models (three ``[B, I_n, R]`` factors, ``lam``
    ``[B, R]``), left-out rows of mode 0 taken as zero."""
    f = [factors[0].nan_to_num(0.0) if rows is not None else factors[0], *factors[1:]]
    f[0] = _zero_rows(f[0], rows)
    g = mttkrp(p.x, f, 2)
    return fit_from_mttkrp(p.norms_sq(f[0].shape[0], rows), p.norm, f, lam, g)


def recon_gap(fa, lam_a, fb, lam_b) -> torch.Tensor:
    """``|model_a - model_b| / |model_b|`` per model pair, from the gramians
    (no dense tensor); float64 keeps the difference's cancellation at about
    1e-8 of the norms."""

    def inner(f, la, g, lg):
        h = torch.ones(la.shape[0], la.shape[1], lg.shape[1], dtype=la.dtype, device=la.device)
        for u, v in zip(f, g):
            h = h * (u.transpose(1, 2) @ v)
        return torch.einsum("br,brs,bs->b", la, h, lg)

    aa, bb, ab = inner(fa, lam_a, fa, lam_a), inner(fb, lam_b, fb, lam_b), inner(fa, lam_a, fb, lam_b)
    return torch.sqrt(torch.clamp(aa + bb - 2 * ab, min=0)) / torch.sqrt(bb)
