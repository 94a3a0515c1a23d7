"""Solver state shared by the iteration and the CALS engine (port of
``cp_cals_tpu/solvers/state.py:70-167``).

Every field carries the leading batch dim ``(B,)`` of a bucket. The
line-search (``ls``) and mixed-tier (``hi``) carries are ``()`` in this
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ktensor import Ktensor
from ..ops.gramians import gramians


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
    active: tuple = ()  # NNLS active sets (not ported yet)
    ls: tuple = ()  # line-search carry (not ported yet)
    hi: tuple = ()  # mixed-tier carry (not ported yet)


def tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of (named) tuples of tensors."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    raise TypeError(f"unsupported state leaf {type(first)}")


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
) -> SolverState:
    """Initial state of a batched Ktensor: gramians of the initial guess,
    iteration counters at 0 (the first iteration makes them 1)."""
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
    return SolverState(
        kt=kt,
        grams=gramians(kt.factors),
        rank_mask=rank_mask,
        iters=torch.zeros(batch_shape, dtype=torch.int32, device=dev),
        fit=zeros,
        old_fit=zeros.clone(),
        approx_error=zeros.clone(),
        converged=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        alive=torch.as_tensor(alive, device=dev).expand(batch_shape).clone(),
        jk_fiber=jk_fiber,
        x_norm_model=x_norm_model,
    )
