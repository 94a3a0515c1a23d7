"""High-level user API (port of ``cp_cals_tpu/api.py``).

The reference's three user-facing drivers (``cp_cals``, ``cp_cals_jk``,
``cp_cals_hybrid``) over plain arrays, with 'random' or explicit initial
guesses and keyword options named after the reference's option strings
(update-method, mttkrp-method, maxiters, buffer-size, tol, ls,
ls-interval, ls-step), with the JAX package's options and defaults.

Two options of the port's own: ``device`` (None: the CUDA card, which must
be present; "cpu" runs the kernels' plain PyTorch versions) and ``dtype``
(float32 by default, float64 on request: the port has no x64 switch that
would pick it for the caller).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .config import CalsParams, LineSearchMethod, MttkrpMethod, UpdateMethod
from .device import resolve_device
from .ktensor import Ktensor, RandomKtensorSpec, float_dtype
from .solvers import cp_cals as _cp_cals_solver
from .solvers import jk_cp_cals as _jk_solver
from .solvers.jackknife import JKReport


def _make_params(
    *,
    tol=1e-7,
    maxiters=200,
    buffer_size=4200,
    update_method="unconstrained",
    mttkrp_method="auto",
    line_search=False,
    line_search_interval=5,
    line_search_step=0.0,
    line_search_method="no_error_checking",
    force_max_iter=False,
    bucket_ranks=(4, 8, 16, 32),
    mttkrp_precision=None,
    tol_check_interval=0,
    polish_iters=0,
    result_wire_dtype=None,
    polish_tol=0.0,
    evict_batch=1,
    mode_layouts="auto",
    dimtree="auto",
    epilogue="auto",
    solve_method="gj",
) -> CalsParams:
    return CalsParams(
        tol=tol,
        max_iterations=maxiters,
        buffer_size=buffer_size,
        update_method=UpdateMethod(update_method),
        mttkrp_method=MttkrpMethod(mttkrp_method),
        line_search=line_search,
        line_search_interval=line_search_interval,
        line_search_step=line_search_step,
        line_search_method=LineSearchMethod(line_search_method),
        force_max_iter=force_max_iter,
        bucket_ranks=tuple(bucket_ranks),
        mttkrp_precision=mttkrp_precision,
        tol_check_interval=tol_check_interval,
        polish_iters=polish_iters,
        result_wire_dtype=result_wire_dtype,
        polish_tol=polish_tol,
        evict_batch=evict_batch,
        mode_layouts=mode_layouts,
        dimtree=dimtree,
        epilogue=epilogue,
        solve_method=solve_method,
    )


def _init_models(shape, ranks, init, dtype: torch.dtype, seed: int) -> list:
    if isinstance(init, str) and init == "random":
        # Generated on the device from their seeds: nothing but seeds is
        # uploaded, and the models depend only on (seed, position).
        name = str(dtype).removeprefix("torch.")
        return [
            RandomKtensorSpec(tuple(shape), int(r), seed=seed * 100003 + i, dtype=name)
            for i, r in enumerate(ranks)
        ]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    models = []
    for m in init:
        if isinstance(m, Ktensor):
            models.append(m)
        else:  # (factors, lam) tuple of arrays
            factors, lam = m
            models.append(Ktensor(tuple(np.asarray(f, np_dtype) for f in factors), np.asarray(lam, np_dtype)))
    return models


@dataclass
class FitResult:
    ktensors: list  # fitted models (host NumPy Ktensors), input order
    # The initial guesses used: Ktensors as passed, or RandomKtensorSpec
    # entries for init='random' (materialize with ktensor.spec_to_ktensor).
    initial: list
    errors: list = field(default_factory=list)
    iters: list = field(default_factory=list)
    fits: list = field(default_factory=list)


def cp_cals(x, ranks: Sequence[int], init="random", seed: int = 0, device=None, dtype=None, **options):
    """Fit one CP model per entry of ``ranks`` concurrently. ``init`` is
    'random' or a list of Ktensors / (factors, lam) tuples matching
    ``ranks``."""
    dev = resolve_device(device)
    dt = float_dtype(dtype)
    x = torch.as_tensor(x).to(dt)
    params = _make_params(**options)
    models = _init_models(x.shape, ranks, init, dt, seed)
    fitted, rep = _cp_cals_solver(x, models, params, device=dev)
    return FitResult(
        ktensors=fitted,
        initial=models,
        errors=[m.approx_error for m in rep.models],
        iters=[m.iters for m in rep.models],
        fits=[m.fit for m in rep.models],
    )


def cp_cals_jk(x, fitted: Sequence[Ktensor], device=None, **options) -> JKReport:
    """Jackknife every fitted model: leave-one-out replicates per mode-0
    sample in one concurrent run, rescaled and matched by LSAP. ``x`` is
    cast to the fitted models' dtype."""
    lam = fitted[0].lam
    dt = float_dtype(lam.dtype if isinstance(lam, torch.Tensor) else np.asarray(lam).dtype)
    params = _make_params(**options)
    return _jk_solver(torch.as_tensor(x).to(dt), list(fitted), params, device=resolve_device(device))


def cp_cals_hybrid(x, ranks: Sequence[int], init="random", seed: int = 0, device=None, dtype=None, **options):
    """Two phases: fit all requested models, pick the best per distinct
    rank, jackknife only those. Returns (FitResult, best models, JKReport)."""
    result = cp_cals(x, ranks, init=init, seed=seed, device=device, dtype=dtype, **options)
    best: dict[int, tuple[float, Ktensor]] = {}
    for kt, err in zip(result.ktensors, result.errors):
        r = kt.rank
        if r not in best or err < best[r][0]:
            best[r] = (err, kt)
    best_models = [kt for _, kt in best.values()]
    jk = cp_cals_jk(x, best_models, device=device, **options)
    return result, best_models, jk
