"""Factor updates: unconstrained and non-negative (port of
``cp_cals_tpu/ops/update.py``).

The unconstrained solves form the unfused ``epilogue="xla"`` path, and they
are the plain building blocks of the fused epilogue kernels' plain versions
(``ops/fused_epilogue.py``).

NNLS (``update_factor_nnls``) is the JAX package's bounded active-set
solver per factor row, block principal pivoting or Lawson-Hanson, with
warm-started active sets. The JAX version is a ``lax.while_loop`` per row
under ``vmap``, which runs until every row is done and keeps the state of
the rows that are; here every row of every model is one batch, each loop
runs JAX's own bound as a fixed trip count, and a row whose condition no
longer holds keeps its state by a select, which gives JAX's results. So
nothing reads a device value on the host and the update can be captured
into a CUDA graph. On the CPU a loop stops as soon as no row runs on (the
same results, fewer trips). The subsystem solves are
``torch.linalg.cholesky_ex`` and two triangular solves; a failed
factorization (``info != 0``) or a NaN in the solution flags the row, as
JAX's NaN-filled Cholesky does, and each of JAX's places falls back to the
all-active zero row.
"""

from __future__ import annotations

import torch

from ..config import NNLS_ALGORITHMS
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
    """H^-1 of a batched SPD matrix via Cholesky and a triangular solve. The
    factorization's status stays on the device (``cholesky_ex``; a failed
    one gives NaN, as XLA's Cholesky does), so the solve reads nothing on
    the host and can be captured into a CUDA graph."""
    chol, info = torch.linalg.cholesky_ex(h)
    chol = torch.where((info == 0)[..., None, None], chol, torch.nan)
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


# ---------------------------------------------------------------- NNLS


def _masked_solve(h: torch.Tensor, y: torch.Tensor, passive: torch.Tensor):
    """Solve the passive subsystem H_pp d_p = y_p of every row by identity
    padding (``cp_cals_tpu/ops/update.py:_masked_solve``).

    h: [M, 1, R, R]; y, passive: [M, I, R]. Returns (d, failed): d is zero
    on the active set and, where ``failed`` ([M, I], a non-SPD subsystem),
    zero everywhere.
    """
    p = passive.to(h.dtype)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    m = h * (p[..., :, None] * p[..., None, :]) + eye * (1.0 - p)[..., None, :]
    chol, info = torch.linalg.cholesky_ex(m, check_errors=False)
    rhs = (y * p)[..., None]
    sol = torch.linalg.solve_triangular(chol, rhs, upper=False)
    sol = torch.linalg.solve_triangular(chol.transpose(-1, -2), sol, upper=True)[..., 0]
    d = torch.where(passive, sol, torch.zeros_like(sol))
    failed = (info != 0) | torch.isnan(d).any(-1)
    return torch.where(failed[..., None], torch.zeros_like(d), d), failed


def _matvec(h: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """H d per row: h [M, 1, R, R], d [M, I, R]."""
    return torch.matmul(h, d[..., None])[..., 0]


def _select(c: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """Per row, ``new`` where the loop condition ``c`` [M, I] held, else
    ``old`` (a batched while loop's step)."""
    return tuple(torch.where(c.reshape(c.shape + (1,) * (a.ndim - c.ndim)), a, b) for a, b in zip(new, old))


def _early_exit(c: torch.Tensor) -> bool:
    """On the CPU, whether no row runs on; on the card never read (the loop
    runs its full bound, so it can be captured)."""
    return c.device.type == "cpu" and not bool(c.any())


def _bpp(h, y, warm, tol, max_outer: int):
    """Block principal pivoting for every row (``update.py:_nnls_row_bpp``):
    all violators exchanged per trip, the single highest-index violator
    once the violation count has not improved for three trips; at most
    ``max_outer`` trips."""
    r = y.shape[-1]
    idx = torch.arange(r, device=y.device)

    def compute(active):
        d, failed = _masked_solve(h, y, ~active)
        return d, y - _matvec(h, d), failed

    def infeasible(active, d, w):
        ok = torch.where(active, w <= tol, d >= -tol)
        return ~ok.all(-1)

    active = warm & ~(y > 0)
    d, w, failed = compute(active)
    active = active | failed[..., None]
    d = torch.where(failed[..., None], torch.zeros_like(d), d)
    rows = y.shape[:-1]
    best = torch.full(rows, r + 1, dtype=torch.int32, device=y.device)
    count = torch.full(rows, 3, dtype=torch.int32, device=y.device)
    for _ in range(max_outer):
        c = infeasible(active, d, w)
        if _early_exit(c):
            break
        viol = (~active & (d < -tol)) | (active & (w > tol))
        nviol = viol.sum(-1, dtype=torch.int32)
        improved = nviol < best
        best_new = torch.minimum(nviol, best)
        count_new = torch.where(improved, torch.full_like(count, 3), count - 1)
        last = torch.amax(torch.where(viol, idx, -1), dim=-1)
        single = viol & (idx == last[..., None])
        swap = torch.where(count_new[..., None] > 0, viol, single)
        active_new = active ^ swap
        d_new, w_new, failed = compute(active_new)
        active_new = active_new | failed[..., None]
        d_new = torch.where(failed[..., None], torch.zeros_like(d_new), d_new)
        active, d, w, best, count = _select(
            c, (active_new, d_new, w_new, best_new, count_new), (active, d, w, best, count))
    return torch.clamp(d, min=0.0), active


def _phase1(h, y, active, tol):
    """Lawson-Hanson's warm-start correction (``update.py:_phase1``): solve
    on the inherited passive set and deactivate non-positive entries until
    none is left; at most R + 1 trips."""
    r = y.shape[-1]
    passive = ~active
    d, failed0 = _masked_solve(h, y, passive)
    active = active | failed0[..., None]
    no_passive = ~passive.any(-1)
    d = torch.where((failed0 | no_passive)[..., None], torch.zeros_like(d), d)
    done = no_passive | failed0
    inf = torch.full_like(d, float("inf"))
    for it in range(r + 1):
        c = ~done
        if _early_exit(c):
            break
        passive = ~active
        need_fix = passive.any(-1) & (torch.where(passive, d, inf).amin(-1) <= tol[..., 0])
        new_active = active | (need_fix[..., None] & (d <= tol))
        all_active = new_active.all(-1)
        d2, failed = _masked_solve(h, y, ~new_active)
        fail = all_active | failed
        new_active = new_active | fail[..., None]
        d2 = torch.where(fail[..., None], torch.zeros_like(d2), d2)
        done_new = ~need_fix | fail | (it >= r)
        fix = need_fix[..., None]
        active, d, done = _select(
            c, (torch.where(fix, new_active, active), torch.where(fix, d2, d), done_new), (active, d, done))
    return active, d


def _lawson_hanson(h, y, warm, tol, max_outer: int):
    """Lawson-Hanson for every row (``update.py:_nnls_row``): the phase-1
    correction, then at most ``max_outer`` outer trips that free the
    first active entry of largest multiplier, each with at most R + 1
    feasible steps."""
    r = y.shape[-1]
    idx = torch.arange(r, device=y.device)
    inf = torch.full_like(y, float("inf"))
    active, d = _phase1(h, y, warm & ~(y > 0), tol)
    w = y - _matvec(h, d)
    for _ in range(max_outer):
        wa = torch.where(active, w, -inf)
        c = active.any(-1) & (wa.amax(-1) > tol[..., 0])
        if _early_exit(c):
            break
        m = torch.argmax(wa, dim=-1)
        act = active & (idx != m[..., None])
        sp, failed = _masked_solve(h, y, ~act)
        dd = d
        for _k in range(r + 1):
            passive = ~act
            ci = (torch.where(passive, sp, inf).amin(-1) <= tol[..., 0]) & ~failed & passive.any(-1)
            if _early_exit(ci & c):
                break
            viol = passive & (sp <= tol)
            alpha = torch.where(viol, dd / (dd - sp), inf).amin(-1, keepdim=True)
            d_new = dd + alpha * (sp - dd)
            newly = passive & (torch.abs(d_new) < tol)
            act_new = act | newly
            d_new = torch.where(newly, torch.zeros_like(d_new), d_new)
            sp2, f2 = _masked_solve(h, y, ~act_new)
            dd, act, sp, failed = _select(ci, (d_new, act_new, sp2, failed | f2), (dd, act, sp, failed))
        fail = failed[..., None]
        d_out = torch.where(fail, torch.zeros_like(dd), torch.where(act, torch.zeros_like(sp), sp))
        act = act | fail
        w_out = y - _matvec(h, d_out)
        d, w, active = _select(c, (d_out, w_out, act), (d, w, active))
    return d, active


def update_factor_nnls(
    g: torch.Tensor, h: torch.Tensor, warm_active: torch.Tensor, max_outer: int = 0,
    algorithm: str = "bpp",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative factor update, batched over models and rows
    (``cp_cals_tpu/ops/update.py:update_factor_nnls``).

    g: [..., I, R] MTTKRP result (each row one right-hand side); h: [..., R,
    R] normal matrix of the model; warm_active: [..., I, R] bool, the
    active sets carried from the previous update. Returns (factor >= 0,
    new active sets). tol = 10 eps |H|_1 R with eps of the dtype;
    ``max_outer`` 0 means 2R + 2.
    """
    if algorithm not in NNLS_ALGORITHMS:
        raise ValueError(f"nnls_algorithm={algorithm!r}: expected one of {NNLS_ALGORITHMS}")
    r = g.shape[-1]
    if max_outer == 0:
        max_outer = 2 * r + 2
    batch = g.shape[:-2]
    gm = g.reshape((-1,) + g.shape[-2:])
    hm = h.reshape((-1, 1) + h.shape[-2:])
    am = warm_active.reshape(gm.shape)
    eps = torch.finfo(h.dtype).eps
    one_norm = torch.abs(hm).sum(-2).amax(-1, keepdim=True)  # [M, 1, 1]
    tol = 10.0 * eps * one_norm * r
    solve = _bpp if algorithm == "bpp" else _lawson_hanson
    d, active = solve(hm, gm, am, tol, max_outer)
    return d.reshape(g.shape), active.reshape(batch + g.shape[-2:])
