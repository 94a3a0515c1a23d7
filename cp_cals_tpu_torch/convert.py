"""Carry models, solver states and parameters across from the JAX package.

The functions take host data only (NumPy arrays, plain dicts, objects with
the JAX package's field names), so this module imports nothing of JAX: pull
a JAX value to the host first, e.g. ``jax.tree.map(np.asarray, state)``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .config import AlsParams, CalsParams
from .device import resolve_device
from .ktensor import Ktensor, RandomKtensorSpec
from .solvers.state import HiState, LsState, SolverState


def _tensor(a, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev, dtype=dtype)


def ktensor_from_numpy(kt, device=None) -> Ktensor:
    """A Ktensor of torch tensors from any object with ``factors`` and
    ``lam`` holding arrays (a JAX Ktensor pulled to NumPy, or NumPy)."""
    dev = resolve_device(device)
    return Ktensor(
        tuple(_tensor(f, dev).contiguous() for f in kt.factors), _tensor(kt.lam, dev)
    )


def spec_from_jax(spec) -> RandomKtensorSpec:
    """The port's ``RandomKtensorSpec`` of a JAX ``RandomKtensorSpec`` (the
    same fields; it generates the same uniform draws)."""
    dtype = None if spec.dtype is None else str(spec.dtype)
    return RandomKtensorSpec(tuple(int(m) for m in spec.modes), int(spec.rank), int(spec.seed), dtype)


def host_ktensors(result) -> list:
    """Host NumPy Ktensors of a JAX ``FitResult``'s fitted models (or of any
    list of Ktensors); an unfinished model (None) stays None."""
    kts = getattr(result, "ktensors", result)
    return [None if kt is None else Ktensor(tuple(np.array(f) for f in kt.factors), np.array(kt.lam))
            for kt in kts]


def state_from_numpy(state, device=None) -> SolverState:
    """A port ``SolverState`` from a JAX ``SolverState`` whose leaves were
    pulled to NumPy, leaf by leaf: the NNLS active sets, the line-search
    carry (its snapshot, backup and backup active sets) and the mixed-tier
    carry included."""
    dev = resolve_device(device)

    def bools(sets):
        return tuple(_tensor(a, dev, torch.bool) for a in sets)

    hi = ()
    if state.hi:
        h = state.hi
        hi = HiState(_tensor(h.fit_prev, dev), _tensor(h.iters_prev, dev, torch.int32),
                     _tensor(h.rate_prev, dev), _tensor(h.gap_prev, dev, torch.int32))
    ls = ()
    if state.ls:
        c = state.ls
        ls = LsState(
            it=_tensor(c.it, dev, torch.int32), updated_last=_tensor(c.updated_last, dev, torch.bool),
            prev=ktensor_from_numpy(c.prev, dev), backup=ktensor_from_numpy(c.backup, dev),
            backup_err=_tensor(c.backup_err, dev), backup_fit=_tensor(c.backup_fit, dev),
            backup_old_fit=_tensor(c.backup_old_fit, dev), backup_iters=_tensor(c.backup_iters, dev, torch.int32),
            backup_active=bools(c.backup_active),
        )
    return SolverState(
        kt=ktensor_from_numpy(state.kt, dev),
        grams=tuple(_tensor(g, dev).contiguous() for g in state.grams),
        rank_mask=_tensor(state.rank_mask, dev, torch.bool),
        iters=_tensor(state.iters, dev, torch.int32),
        fit=_tensor(state.fit, dev),
        old_fit=_tensor(state.old_fit, dev),
        approx_error=_tensor(state.approx_error, dev),
        converged=_tensor(state.converged, dev, torch.bool),
        alive=_tensor(state.alive, dev, torch.bool),
        jk_fiber=_tensor(state.jk_fiber, dev, torch.int32),
        x_norm_model=_tensor(state.x_norm_model, dev),
        active=bools(state.active),
        ls=ls,
        hi=hi,
    )


def params_from_dict(d: dict, kind: str = "cals") -> AlsParams | CalsParams:
    """``AlsParams``/``CalsParams`` from a field dict, such as
    ``dataclasses.asdict`` of the JAX package's params. Enum members of
    either package (``update_method``, ``line_search_method``, ...) are
    mapped by value; ``nnls_algorithm`` is a string in both."""
    cls = {"als": AlsParams, "cals": CalsParams}[kind]
    types = {f.name: f.type for f in dataclasses.fields(cls)}
    defaults = cls()
    out = {}
    for k, v in d.items():
        if k not in types:
            raise ValueError(f"{cls.__name__} has no field {k!r}")
        cur = getattr(defaults, k)
        if isinstance(cur, enum.Enum):
            v = type(cur)(getattr(v, "value", v))
        elif isinstance(cur, tuple):
            v = tuple(v)
        out[k] = v
    return cls(**out)
