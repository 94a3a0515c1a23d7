"""One batched ALS iteration over a SolverState (port of the main-path
subset of ``cp_cals_tpu/solvers/iteration.py:57-501``); the unbatched
iteration of one model runs it as a batch of one.

Per mode: the MTTKRP by the mode's method (``mttkrp_methods``, the
engine's per-bucket picks from the lookup table; without them
``config.resolve_mttkrp_method``: under AUTO the fused kernels where their
gate takes the mode, the twostep elsewhere, every mode of an N-D tensor
included; or the method asked for), or under
``dimtree="on"`` (3-D) modes 1 and 2 from one shared TTM after the mode-0
update; then either the fused epilogue kernels (``epilogue="fused"``, the
default here) or the unfused PyTorch path (``epilogue="xla"``). The fused
path is taken mode by mode: a mode whose shape the kernels do not take
(``ops/fused_epilogue.py:supports_fused_epilogue``) goes through the
unfused path, as in the JAX iteration. After the last mode come the FastALS
error, the fit and the convergence flags, with the mixed-tier stopping
check where ``tol_check_interval > 0``.

PyTorch runs eagerly, so ``make_iteration`` returns a plain function. The
same function runs eagerly in the per-iteration host loop and is captured
into a CUDA graph by the engine's device-paced loop (``graph_loop.py``), so
nothing in it reads a device value on the host. Its ``.prepare(x)`` resolves
the per-mode methods and builds the loop-invariant tensor layouts once per
solve, held for the MTTKRP's precision tier (the fused kernels' layouts at
the bf16 tiers hold X rounded, once), and also at ``params.precision``
where the mixed-tier check runs there (``Held.hi``; the engine's polish
sweeps are an iteration of their own at that tier).
Given a dict ``layouts``, it takes each layout from there, keyed by
(mode, method, tier), and puts what it builds there, so the engine's
buckets share the layouts they agree on; ``refresh_layouts`` writes a new
X's layouts into such a dict in place, for CUDA graphs that read them.
Given ``policy``, the layout policy its caller resolved once for the call
(the engine, ``solvers/cals.py``), it follows that; else it resolves
``params.mode_layouts`` on X (``config.resolve_layouts``). Under
``"recompute"`` (``"auto"``: on a CUDA card where the held layouts would
take more than a quarter of its memory, elsewhere where X takes more than
128 MB) nothing is held: each MTTKRP derives its layout inside the
iteration, and in a captured CUDA graph the copies come from the graph's
pool, so the peak is about X plus one layout and its temporaries. A held
layout's build or rebuild is a span ``layouts.build`` and counts its bytes
on ``layouts.held_bytes`` (``utils/timers.py``); a derived one counts on
``layouts.derived`` and ``layouts.derived_bytes`` (``ops/mttkrp.py``).

Under ``update_method=NNLS`` every mode takes the unfused path with the
batched NNLS update (``ops/update.py:update_factor_nnls``), whatever
``epilogue`` says, as in the JAX iteration; the MTTKRP still goes through
the fused kernels where their gate takes the mode. Under ``line_search``
the iteration snapshots the model at ``it == interval - 1`` before the
sweep and runs the line search after the FastALS error (``line_search``).
JAX skips work with ``lax.cond`` where no model is at its interval; here
the work is done and its result selected by ``torch.where`` on the device,
so the results are JAX's: NO_ERROR_CHECKING's gramian refresh runs every
iteration, and ERROR_CHECKING's candidate MTTKRP goes through the last
mode's method with the fused kernels' launch predicate (a twostep or
krp_gemm last mode runs every iteration).

``debug`` is the JAX package's monotonicity hook: every model whose error
rose by more than 1e-4 adds ``(iteration, old_error, new_error)`` to
``MONOTONICITY_VIOLATIONS`` (at most 16 per iteration) with a warning. It
reads the device on the host, so a debug run is never captured into a
CUDA graph: the engine runs it eagerly, one iteration per chunk.

Dead and padded slots are inert (zero factors, zero lam, identity normal
matrix), so nothing inside the iteration is gated on ``alive``.

Under a tp mesh (``tp``, a ``parallel.sharding.TpRows``) X and every factor
0 hold this rank's rows of mode 0, and the iteration sums over the tp group
what those rows leave partial: the MTTKRP of every mode >= 1 (the check's
and the ERROR_CHECKING candidate's too), the dimension tree's shared TTM,
and the factor-0 gramians and column norms of the line searches. Mode 0's
MTTKRP is complete on its rows, the FastALS error on the last mode reads
summed operands only, and the updates (NNLS too) are row by row. The
normalization is not (lam, the rescaled gramian), so mode 0 is normalized
whole on every rank, as GSPMD gathers the sharded operand around the JAX
package's Pallas apply: mode 0's G (for the apply kernel) or U (unfused)
is gathered whole on every rank of the tp group (``TpRows.gather``), every
rank computes the same bits from the same inputs, and keeps its rows.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from ..config import (
    AlsParams,
    CalsParams,
    LineSearchMethod,
    UpdateMethod,
    check_supported,
    resolve_dimtree,
    resolve_epilogue,
    resolve_layouts,
    resolve_mttkrp_method,
)
from ..ktensor import Ktensor, denormalize, normalize_factor_fused, normalize_full, scale_jk_rows
from ..ops.error import fast_error
from ..ops.fused_epilogue import epilogue_apply, normal_inverse, supports_fused_epilogue
from ..ops.gramians import gramians, hadamard_all, hadamard_but_one
from ..ops.mttkrp import (
    dimtree_layout,
    dimtree_ttm,
    dimtree_ttv,
    layout_bytes,
    mttkrp_batched,
    prepare_mode,
    resolve_batched_method,
)
from ..ops.update import padded_hadamard, update_factor_nnls, update_factor_unconstrained
from ..utils import timers
from .state import BIG_ERROR, HiState, LsState, SolverState, tree_map, tree_where


class Held(tuple):
    """The per-mode held layouts of X at the MTTKRP's tier (None for a
    layout derived inside the iteration), and under the dimension tree one
    more slot, the shared TTM's layout (``[n_modes]``, as in the JAX
    package). ``methods`` holds each mode's resolved MTTKRP method. ``hi``
    holds the layouts at ``params.precision``, the tier of the mixed-tier
    check's MTTKRP: the same tuple where the two tiers agree, None where no
    check runs; only the fused kernels' layouts depend on the tier, the
    others are shared."""

    hi: "Held | None" = None
    methods: tuple = ()


def extrapolated_delta(rate: torch.Tensor, rate_prev: torch.Tensor, gap: torch.Tensor) -> torch.Tensor:
    """The current per-iteration fit delta, estimated from two consecutive
    window-average rates (``cp_cals_tpu/solvers/iteration.py:57``).

    With geometrically decaying deltas d_i = d_k rho^(i-k), the two windows
    give rate / rate_prev = rho^gap, and the newest delta is
    rate * gap * (1 - rho) * rho^(gap-1) / (1 - rho^gap), in that bounded
    form (rho^gap lies in [0, 1]). It is used where two positive rates are
    on record and rho < 1; else the raw window rate. rho is clamped at 0.2.
    """
    have2 = (rate_prev > 0) & (rate > 0)
    one = torch.ones_like(rate)
    ratio = torch.where(have2, rate, one) / torch.where(have2, rate_prev, one)
    rho = torch.clamp(ratio ** (1.0 / gap), 0.2, 1.0)
    rho_g = rho**gap
    d_k = rate * gap * (1.0 - rho) * (rho_g / rho) / torch.clamp(1.0 - rho_g, min=1e-30)
    return torch.where(have2 & (rho < 1.0), d_k, rate)


# The debug hook's record (``params.debug``): (iteration, old_error,
# new_error) of each model whose error rose by more than 1e-4, as the JAX
# package's ``MONOTONICITY_VIOLATIONS``. Inspected and cleared by callers.
MONOTONICITY_VIOLATIONS: list = []


def record_monotonicity_violations(viol, iters, err, prev_err) -> None:
    """The first 16 violations of one iteration, in slot order, and a
    warning (``cp_cals_tpu/solvers/iteration.py:348-368``). Reads the
    device on the host: never inside a CUDA-graph capture."""
    if viol.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("debug=True reads the device on the host and cannot be captured")
    v = viol.cpu().numpy()
    if not v.any():
        return
    it, e, pe = iters.cpu().numpy(), err.cpu().numpy(), prev_err.cpu().numpy()
    for i in v.nonzero()[0][:16]:
        MONOTONICITY_VIOLATIONS.append((int(it[i]), float(pe[i]), float(e[i])))
    warnings.warn(f"approximation error increased for {int(v.sum())} model(s) (> 1e-4)", stacklevel=2)


def cube_root(t: torch.Tensor) -> torch.Tensor:
    """cbrt of a positive tensor: the power, then one Newton step, which
    rounds exact cubes to their root as ``jnp.cbrt`` does."""
    y = t ** (1.0 / 3.0)
    return y - (y * y * y - t) / (3.0 * y * y)


def held_layout(x: torch.Tensor, key, into: torch.Tensor | None = None) -> torch.Tensor:
    """The held layout of ``x`` under a key of ``prepare``'s dict: (mode,
    method, tier, or None where the method's layout has none), or
    ``"dimtree"``, the shared TTM's; with ``into``, written into that
    layout in place. A span ``layouts.build``, its bytes counted on
    ``layouts.held_bytes`` (none for a view of ``x``)."""
    with timers.span("layouts.build"):
        if key == "dimtree":
            t = dimtree_layout(x).contiguous()
        else:
            n, m, tier = key
            t = prepare_mode(x, n, m, tier or "highest")
        if into is not None:
            t = into.copy_(t)
    timers.count("layouts.held_bytes", layout_bytes(x, t))
    return t


def refresh_layouts(x: torch.Tensor, layouts: dict) -> None:
    """Every layout of ``layouts`` (``prepare``'s dict) rebuilt from ``x``
    in place, one at a time; a layout that is a view of ``x`` follows it."""
    for key, t in layouts.items():
        if layout_bytes(x, t):
            held_layout(x, key, into=t)


def make_iteration(
    params: AlsParams | CalsParams,
    batched: bool = True,
    mttkrp_methods: tuple[str, ...] | None = None,
    has_jk: bool = True,
    tp=None,
) -> Callable[..., SolverState]:
    """Build the iteration for the given params.

    mttkrp_methods optionally gives each mode's MTTKRP method (the engine's
    per-bucket picks under AUTO, ``solvers/cals.py:_resolve_bucket_methods``);
    the mixed-tier check's MTTKRP takes the last mode's.

    has_jk=False leaves out the jackknife row zero of mode 0 for queues
    without jackknife models.

    tp: None, or the ``parallel.sharding.TpRows`` of a mesh that splits
    mode 0 (module docstring).

    batched=False takes the JAX package's unbatched state (factors
    ``[I_n, R]``, lam ``[R]``, scalar counters and flags) and runs it as a
    batch of one through the batched iteration: the leading axis is added
    to every leaf, and dropped again from the result.
    """
    if not batched:
        step = make_iteration(params, True, mttkrp_methods, has_jk, tp)

        def unbatched(x, state: SolverState, x_norm_full, prepared=None) -> SolverState:
            out = step(x, tree_map(lambda t: t.unsqueeze(0), state), x_norm_full, prepared)
            return tree_map(lambda t: t[0], out)

        unbatched.prepare = step.prepare
        return unbatched
    check_supported(params)
    precision = params.precision
    mttkrp_prec = params.mttkrp_precision or precision
    nnls = params.update_method == UpdateMethod.NNLS
    # NNLS never takes the fused epilogue, whatever `epilogue` says.
    fused = not nnls and resolve_epilogue(params) == "fused"
    nec = params.line_search_method == LineSearchMethod.NO_ERROR_CHECKING
    k_check = params.tol_check_interval
    # The check's MTTKRP runs at `precision`.
    need_hi = k_check > 0
    # The sum over the tp group of what mode 0's split rows leave partial.
    psum = tp.sum if tp is not None else (lambda t: t)

    def prepare(x, layouts: dict | None = None, policy: str | None = None) -> Held:
        n_modes = x.ndim
        if mttkrp_methods is not None:
            methods = tuple(mttkrp_methods)
        else:
            methods = resolve_mttkrp_method(params, tuple(x.shape), x.dtype, x.device)
        dimtree = resolve_dimtree(params, n_modes)
        layouts = {} if layouts is None else layouts

        def layout(n, tier):
            """Mode n's layout for its method; only the fused kernels' depends
            on the tier."""
            m = resolve_batched_method(methods[n], x.shape, n, x.dtype, x.device)
            key = (n, m, tier if m == "pallas" else None)
            if key not in layouts:
                layouts[key] = held_layout(x, key)
            return layouts[key]

        if (policy or resolve_layouts(params, x)) == "recompute":
            held = Held((None,) * (n_modes + dimtree))
        else:
            if dimtree and "dimtree" not in layouts:
                layouts["dimtree"] = held_layout(x, "dimtree")
            held = Held(tuple(layout(n, mttkrp_prec) for n in range(n_modes))
                        + ((layouts["dimtree"],) if dimtree else ()))
        held.methods = methods
        if need_hi:
            held.hi = held if precision == mttkrp_prec or held[0] is None else Held(
                tuple(layout(n, precision) for n in range(n_modes)) + held[n_modes:])
            held.hi.methods = methods
        return held

    def check(x, state, kt, grams, iters, err, fit, x_norm_full, prepared, method, not_pending):
        """The mixed-tier stopping check (``cp_cals_tpu/solvers/iteration.py:
        383-477``): at the batch's check iterations (adjacent pairs mK-1 and
        mK of the oldest live model's count), one more last-mode MTTKRP at
        full precision, whose fit and error replace the fast-tier ones and
        decide convergence. `at_check` stays on the device: the MTTKRP
        kernel takes it as its launch predicate, and the outputs are
        selected by it, as the JAX lax.cond's false branch returns zeros
        and the old values. `not_pending` (None, or under NO_ERROR_CHECKING
        line search the models not extrapolated blindly on this iteration)
        keeps a model whose extrapolation is unchecked from stopping."""
        hi = state.hi
        live = state.alive & ~state.converged
        oldest = torch.amax(torch.where(live, iters, 0))
        phase = oldest % k_check
        at_check = (phase == 0) | (phase == k_check - 1)
        last = x.ndim - 1
        # A twostep or krp_gemm last mode has no device predicate: it runs
        # every iteration and its result is selected below.
        g_hi = psum(mttkrp_batched(x, kt.factors, last, method, precision, prepared.hi[last],
                                   pred=at_check.to(torch.int32).reshape(1)))
        err_hi = fast_error(state.x_norm_model, kt.lam, kt.factors[-1], g_hi, hadamard_all(grams))
        fit_hi = 1.0 - torch.abs(err_hi) / x_norm_full
        gap_i = torch.clamp(iters - hi.iters_prev, min=1)
        gap = gap_i.to(fit_hi.dtype)
        # The signed improvement rate; at gap 1 (the decision check after
        # its adjacent pre-check) the exact high-tier delta.
        rate = (fit_hi - hi.fit_prev) / gap
        seen = hi.iters_prev > 0
        rp = torch.where(gap_i == hi.gap_prev, hi.rate_prev, torch.zeros_like(hi.rate_prev))
        d_k = torch.where(gap_i == 1, rate, extrapolated_delta(rate, rp, gap))
        conv = seen & (d_k < params.tol)
        if not_pending is not None:
            conv = conv & not_pending
        checked = HiState(
            fit_prev=fit_hi,
            iters_prev=iters,
            rate_prev=torch.where(seen, rate, torch.zeros_like(rate)),
            gap_prev=torch.where(seen, gap_i, torch.zeros_like(gap_i)),
        )
        return (
            conv & at_check,
            tree_where(at_check, checked, hi),
            torch.where(at_check, err_hi, err),
            torch.where(at_check, fit_hi, fit),
        )

    def line_search(x, kt, grams, err, fit, old_fit, iters, ls: LsState, active, x_norm_full,
                    x_norm_model, prepared, method):
        """The masked batched line search (``cp_cals_tpu/solvers/iteration.py:
        _line_search``): every ``interval`` iterations extrapolate U <- U +
        step (U - U_prev), step = cbrt(iteration) unless given.
        NO_ERROR_CHECKING extrapolates blindly with a backup, reverted on
        the next iteration if the error rose (the NNLS active sets with
        it); ERROR_CHECKING measures the candidate's exact error and
        accepts only an improvement (keeping the active sets)."""
        interval = params.line_search_interval
        if params.line_search_step == 0:
            step = cube_root(iters.to(err.dtype))
        else:
            step = torch.full_like(err, params.line_search_step)
        s = step[:, None, None]
        if nec:
            do_ls = iters < params.max_iterations  # no extrapolation left unchecked
            it2 = torch.where(do_ls, ls.it + 1, ls.it)
            revert = ls.updated_last & do_ls & (ls.backup_err < err)
            kt = tree_where(revert, ls.backup, kt)
            active = tree_where(revert, ls.backup_active, active)
            err = torch.where(revert, ls.backup_err, err)
            fit = torch.where(revert, ls.backup_fit, fit)
            old_fit = torch.where(revert, ls.backup_old_fit, old_fit)
            iters = torch.where(revert, ls.backup_iters, iters)
            it2 = torch.where(revert, torch.zeros_like(it2), it2)
            extrap = (it2 == interval) & do_ls
            it2 = torch.where(extrap, torch.zeros_like(it2), it2)
            kt_d, prev_d = denormalize(kt), denormalize(ls.prev)
            ext = normalize_full(Ktensor(
                tuple(f + s * (f - pf) for f, pf in zip(kt_d.factors, prev_d.factors)),
                torch.ones_like(kt.lam)), tp)
            ls = LsState(
                it=it2, updated_last=(ls.updated_last & ~do_ls) | extrap, prev=ls.prev,
                backup=tree_where(extrap, kt, ls.backup),
                backup_err=torch.where(extrap, err, ls.backup_err),
                backup_fit=torch.where(extrap, fit, ls.backup_fit),
                backup_old_fit=torch.where(extrap, old_fit, ls.backup_old_fit),
                backup_iters=torch.where(extrap, iters, ls.backup_iters),
                backup_active=tree_where(extrap, active, ls.backup_active),
            )
            kt = tree_where(extrap, ext, kt)
            err = torch.where(extrap, torch.full_like(err, BIG_ERROR), err)
            old_fit = torch.where(extrap, fit, old_fit)
            fit = torch.where(extrap, torch.full_like(fit, 1.0 - BIG_ERROR), fit)
            # JAX refreshes the gramians only when some model was touched
            # (lax.cond); here every iteration, selected per model.
            grams = tree_where(revert | extrap, gramians(kt.factors, tp), grams)
            return kt, grams, err, fit, old_fit, iters, ls, active
        it2 = ls.it + 1
        extrap = it2 == interval
        it2 = torch.where(extrap, torch.zeros_like(it2), it2)
        cand = normalize_full(denormalize(Ktensor(
            tuple(f + s * (f - pf) for f, pf in zip(kt.factors, ls.prev.factors)), kt.lam)), tp)
        # The candidate's exact error (``_exact_error``): one more last-mode
        # MTTKRP by the mode's method at the MTTKRP's tier, launched by the
        # fused kernels only where some model is at its interval.
        last = x.ndim - 1
        g_last = psum(mttkrp_batched(x, cand.factors, last, method, mttkrp_prec, prepared[last],
                                     pred=extrap.any().to(torch.int32).reshape(1)))
        new_err = fast_error(x_norm_model, cand.lam, cand.factors[last], g_last,
                             hadamard_all(gramians(cand.factors, tp)))
        accept = extrap & (new_err < err)
        kt = tree_where(accept, cand, kt)
        grams = tree_where(accept, gramians(kt.factors, tp), grams)
        old_fit = torch.where(accept, fit, old_fit)
        fit = torch.where(accept, 1.0 - torch.abs(new_err) / x_norm_full, fit)
        err = torch.where(accept, new_err, err)
        return kt, grams, err, fit, old_fit, iters, ls._replace(it=it2), active

    def iteration(x, state: SolverState, x_norm_full, prepared=None) -> SolverState:
        if prepared is None:
            prepared = prepare(x)
        methods = prepared.methods
        n_modes = x.ndim
        dimtree = resolve_dimtree(params, n_modes)
        iters = state.iters + 1
        kt, grams, active, ls = state.kt, state.grams, state.active, state.ls
        if params.line_search:
            # The snapshot of the model before the sweep, one short of the
            # interval.
            ls = ls._replace(prev=tree_where(ls.it == params.line_search_interval - 1, kt, ls.prev))
        g_last = err = shared = None
        for n in range(n_modes):
            split = tp is not None and n == 0  # mode 0's rows split over the tp group
            if dimtree and n >= 1:
                # Modes 1 and 2 from one TTM with the just-updated (and
                # jackknife-zeroed) mode-0 factor.
                if shared is None:
                    shared = psum(dimtree_ttm(x, kt.factors[0], mttkrp_prec, prepared[n_modes]))
                g = dimtree_ttv(shared, kt.factors, n, mttkrp_prec)
            else:
                g = mttkrp_batched(x, kt.factors, n, methods[n], mttkrp_prec, prepared[n])
                if n >= 1:
                    g = psum(g)
            if n == n_modes - 1:
                g_last = g
            b, i_n, r = g.shape
            if fused and supports_fused_epilogue(b, tp.size if split else i_n, r, g.dtype, n_modes, g.device):
                if split:
                    g = tp.gather(g)
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
                if nnls:
                    u, act_n = update_factor_nnls(g, h, active[n], params.nnls_max_outer, params.nnls_algorithm)
                    active = active[:n] + (act_n,) + active[n + 1 :]
                else:
                    u = update_factor_unconstrained(g, h, solve=params.solve_method)
                if split:
                    # The update is row by row; the normalization is not.
                    u = tp.gather(u)
                if n == 0 and has_jk:
                    u = scale_jk_rows(u, state.jk_fiber, 0.0)
                f_new, lam_new, gm = normalize_factor_fused(u, iters)
            if split:
                f_new = f_new[:, tp.start : tp.stop].contiguous()
            kt = Ktensor(kt.factors[:n] + (f_new,) + kt.factors[n + 1 :], lam_new)
            grams = grams[:n] + (gm,) + grams[n + 1 :]

        if err is None:
            err = fast_error(
                state.x_norm_model, kt.lam, kt.factors[-1], g_last, hadamard_all(grams)
            )
        old_fit = state.fit
        # Fit uses the FULL tensor norm, even for jackknife models.
        fit = 1.0 - torch.abs(err) / x_norm_full
        if params.debug:
            # The first iteration has no previous error; a blindly
            # extrapolated model's BIG_ERROR cannot trigger it.
            viol = (iters > 1) & state.alive & ((state.approx_error - err) < -1e-4)
            record_monotonicity_violations(viol, iters, err, state.approx_error)
        if params.line_search:
            kt, grams, err, fit, old_fit, iters, ls, active = line_search(
                x, kt, grams, err, fit, old_fit, iters, ls, active, x_norm_full, state.x_norm_model,
                prepared, methods[-1])
        hi = state.hi
        if params.force_max_iter:
            converged = iters >= params.max_iterations
        elif k_check > 0:
            # A model extrapolated blindly on this iteration must not stop
            # before its check on the next.
            not_pending = ~ls.updated_last if params.line_search and nec else None
            conv, hi, err, fit = check(
                x, state, kt, grams, iters, err, fit, x_norm_full, prepared, methods[-1], not_pending
            )
            converged = conv | (iters >= params.max_iterations)
        else:
            converged = (torch.abs(fit - old_fit) < params.tol) | (
                iters >= params.max_iterations
            )
        return state._replace(
            kt=kt, grams=grams, iters=iters, fit=fit, old_fit=old_fit,
            approx_error=err, converged=converged, active=active, ls=ls, hi=hi,
        )

    iteration.prepare = prepare
    return iteration
