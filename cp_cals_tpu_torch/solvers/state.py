"""Solver state shared by the iteration and the CALS engine (port of
``cp_cals_tpu/solvers/state.py:45-167``).

Every field carries the leading batch dim ``(B,)`` of a bucket. The
mixed-tier carry ``hi`` is a ``HiState`` when ``tol_check_interval > 0``,
the NNLS carry ``active`` per-mode active sets under
``update_method=NNLS``, and the line-search carry ``ls`` an ``LsState``
under ``line_search``; each is ``()`` otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ktensor import Ktensor
from ..ops.gramians import gramians


# The error a blindly extrapolated model carries until its check (the JAX
# package's sentinel: large and finite, so fit differences stay finite).
BIG_ERROR = 1e30


class LsState(NamedTuple):
    """Line-search carry (``cp_cals_tpu/solvers/state.py:LsState``): the
    counter modulo the interval, whether the model was extrapolated on the
    previous iteration, the snapshot taken at ``it == interval - 1``, and
    the backup a NO_ERROR_CHECKING revert restores (with the NNLS active
    sets at backup time, ``()`` without NNLS)."""

    it: torch.Tensor  # [B] int32
    updated_last: torch.Tensor  # [B] bool
    prev: Ktensor
    backup: Ktensor
    backup_err: torch.Tensor
    backup_fit: torch.Tensor
    backup_old_fit: torch.Tensor
    backup_iters: torch.Tensor  # [B] int32
    backup_active: tuple = ()


class HiState(NamedTuple):
    """Mixed-tier stopping carry (``tol_check_interval``): each model's
    full-precision fit and iteration count at its last periodic check, and
    the window rate and length measured there (0 until two checks are on
    record), for the decay extrapolation of phase-shifted windows
    (``iteration.extrapolated_delta``)."""

    fit_prev: torch.Tensor  # [B], high-tier fit at the previous check
    iters_prev: torch.Tensor  # [B] int32, the model's iters at that check
    rate_prev: torch.Tensor  # [B], per-iteration rate of the previous window
    gap_prev: torch.Tensor  # [B] int32, that window's length


class SolverState(NamedTuple):
    kt: Ktensor  # factors [B, I_n, R], lam [B, R]
    grams: tuple  # per-mode [B, R, R]
    rank_mask: torch.Tensor  # [B, R] bool, False on padded columns
    iters: torch.Tensor  # [B] int32
    fit: torch.Tensor  # [B]
    old_fit: torch.Tensor
    approx_error: torch.Tensor
    converged: torch.Tensor  # [B] bool
    alive: torch.Tensor  # [B] bool, False for vacant slots
    jk_fiber: torch.Tensor  # [B] int32, -1 = not a jackknife model
    x_norm_model: torch.Tensor  # [B], leave-one-out norm for JK models
    active: tuple = ()  # NNLS active sets, per-mode [B, I_n, R] bool, or ()
    ls: LsState | tuple = ()  # line-search carry, () unless line_search
    hi: HiState | tuple = ()  # mixed-tier carry, () unless tol_check_interval > 0


def tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of (named) tuples of tensors."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    raise TypeError(f"unsupported state leaf {type(first)}")


def tree_leaves(tree) -> list:
    """The tensor leaves of (named) tuples of tensors, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in tree_leaves(part)]


def tree_where(cond: torch.Tensor, a, b):
    """Select leaves of two states by a mask over the leading batch dim."""

    def sel(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim))
        return torch.where(c, x, y)

    return tree_map(sel, a, b)


def init_state(
    kt: Ktensor,
    x_norm,
    *,
    jk_fiber=None,
    x_norm_model=None,
    rank_mask=None,
    alive: bool | torch.Tensor = True,
    nnls: bool = False,
    line_search: bool = False,
    mixed_tol: bool = False,
    tp=None,
) -> SolverState:
    """Initial state of a batched Ktensor: gramians of the initial guess,
    iteration counters at 0 (the first iteration makes them 1); with
    ``nnls`` all-active sets, with ``line_search`` an ``LsState`` whose
    snapshot and backup are the initial Ktensor, and with ``mixed_tol`` a
    zero ``HiState``. ``tp`` (a ``parallel.sharding.TpRows``): factor 0
    holds this rank's rows of mode 0, and its gramian sums over the
    ranks."""
    batch_shape = tuple(kt.lam.shape[:-1])
    dev, dtype = kt.lam.device, kt.lam.dtype
    r = kt.rank
    zeros = torch.zeros(batch_shape, dtype=dtype, device=dev)
    if rank_mask is None:
        rank_mask = torch.ones(batch_shape + (r,), dtype=torch.bool, device=dev)
    if jk_fiber is None:
        jk_fiber = torch.full(batch_shape, -1, dtype=torch.int32, device=dev)
    else:
        jk_fiber = torch.as_tensor(jk_fiber, dtype=torch.int32, device=dev)
        jk_fiber = jk_fiber.expand(batch_shape).contiguous()
    if x_norm_model is None:
        x_norm_model = x_norm
    x_norm_model = torch.as_tensor(x_norm_model, dtype=dtype, device=dev)
    x_norm_model = x_norm_model.expand(batch_shape).contiguous()
    active = tuple(torch.ones(f.shape, dtype=torch.bool, device=dev) for f in kt.factors) if nnls else ()
    ls = ()
    if line_search:
        i0 = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
        ls = LsState(it=i0, updated_last=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
                     prev=kt, backup=kt, backup_err=zeros.clone(), backup_fit=zeros.clone(),
                     backup_old_fit=zeros.clone(), backup_iters=i0.clone(), backup_active=active)
    hi = ()
    if mixed_tol:
        i0 = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
        hi = HiState(fit_prev=zeros.clone(), iters_prev=i0, rate_prev=zeros.clone(), gap_prev=i0.clone())
    return SolverState(
        kt=kt,
        grams=gramians(kt.factors, tp),
        rank_mask=rank_mask,
        iters=torch.zeros(batch_shape, dtype=torch.int32, device=dev),
        fit=zeros,
        old_fit=zeros.clone(),
        approx_error=zeros.clone(),
        converged=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        alive=torch.as_tensor(alive, device=dev).expand(batch_shape).clone(),
        jk_fiber=jk_fiber,
        x_norm_model=x_norm_model,
        active=active,
        ls=ls,
        hi=hi,
    )
