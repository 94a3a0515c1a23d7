"""One batched ALS iteration over a SolverState (port of the main-path
subset of ``cp_cals_tpu/solvers/iteration.py:128-501``).

Per mode: the fused MTTKRP, then either the fused epilogue kernels
(``epilogue="fused"``, the default here) or the unfused PyTorch path
(``epilogue="xla"``); after the last mode the FastALS error, the fit and
the convergence flags. PyTorch runs eagerly, so ``make_iteration`` returns
a plain function; its ``.prepare(x)`` builds the loop-invariant tensor
layouts once per solve, outside the loop, held for the MTTKRP's precision
tier (at the bf16 tiers X is rounded there, once).

Dead and padded slots are inert (zero factors, zero lam, identity normal
matrix), so nothing inside the iteration is gated on ``alive``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import (
    AlsParams,
    CalsParams,
    check_supported,
    resolve_epilogue,
    resolve_mttkrp_method,
)
from ..ktensor import Ktensor, normalize_factor_fused, scale_jk_rows
from ..ops.error import fast_error
from ..ops.fused_epilogue import epilogue_apply, normal_inverse
from ..ops.gramians import hadamard_all, hadamard_but_one
from ..ops.mttkrp import mttkrp_batched, prepare_batched
from ..ops.update import padded_hadamard, update_factor_unconstrained
from .state import SolverState


def make_iteration(
    params: AlsParams | CalsParams,
    batched: bool = True,
    has_jk: bool = True,
) -> Callable[..., SolverState]:
    """Build the iteration for the given params.

    has_jk=False leaves out the jackknife row zero of mode 0 for queues
    without jackknife models.
    """
    if not batched:
        raise NotImplementedError(
            "the unbatched iteration is not ported: cp_als runs one model as a "
            "batch of one (ROADMAP section 3)"
        )
    check_supported(params)
    mttkrp_prec = params.mttkrp_precision or params.precision
    fused = resolve_epilogue(params) == "fused"

    def methods_for(x) -> tuple[str, ...]:
        return tuple(resolve_mttkrp_method(params, x.ndim) for _ in range(x.ndim))

    def prepare(x):
        return prepare_batched(x, methods_for(x), mttkrp_prec)

    def iteration(x, state: SolverState, x_norm_full, prepared=None) -> SolverState:
        if prepared is None:
            prepared = prepare(x)
        methods = methods_for(x)
        n_modes = x.ndim
        iters = state.iters + 1
        kt, grams = state.kt, state.grams
        g_last = err = None
        for n in range(n_modes):
            g = mttkrp_batched(x, kt.factors, n, methods[n], mttkrp_prec, prepared[n])
            if n == n_modes - 1:
                g_last = g
            if fused:
                hinv = normal_inverse(grams, state.rank_mask, n)
                # The last mode's apply also finishes the FastALS error, from
                # the other modes' new gramians (hadamard_all's mode order).
                err_inputs = (state.x_norm_model, *grams[:n]) if n == n_modes - 1 else None
                f_new, lam_new, gm, err = epilogue_apply(
                    g, hinv, iters, state.jk_fiber, zero_jk=(n == 0 and has_jk),
                    err_inputs=err_inputs,
                )
            else:
                h = padded_hadamard(hadamard_but_one(grams, n), state.rank_mask)
                u = update_factor_unconstrained(g, h, solve=params.solve_method)
                if n == 0 and has_jk:
                    u = scale_jk_rows(u, state.jk_fiber, 0.0)
                f_new, lam_new, gm = normalize_factor_fused(u, iters)
            kt = Ktensor(kt.factors[:n] + (f_new,) + kt.factors[n + 1 :], lam_new)
            grams = grams[:n] + (gm,) + grams[n + 1 :]

        if err is None:
            err = fast_error(
                state.x_norm_model, kt.lam, kt.factors[-1], g_last, hadamard_all(grams)
            )
        old_fit = state.fit
        # Fit uses the FULL tensor norm, even for jackknife models.
        fit = 1.0 - torch.abs(err) / x_norm_full
        if params.force_max_iter:
            converged = iters >= params.max_iterations
        else:
            converged = (torch.abs(fit - old_fit) < params.tol) | (
                iters >= params.max_iterations
            )
        return state._replace(
            kt=kt, grams=grams, iters=iters, fit=fit, old_fit=old_fit,
            approx_error=err, converged=converged,
        )

    iteration.prepare = prepare
    return iteration
