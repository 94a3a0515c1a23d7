"""Component-level device profile of the CALS iteration on the card (the
counterpart of ``scripts/profile_iteration.py``: its flags and keys).

    python -m cp_cals_tpu_torch.profiles.profile_iteration [--modes 299-301-41]
        [--batch 96] [--rank 20] [--n-loop 20] [--components]
        [--precisions high] [--epilogue auto] [--mttkrp-precision TIER]
        [--skip-peaks] [--skip-iteration] [--skip-mttkrp]
        [--device cuda] [--out chiprun_out/profiles/profile.json]

Each time is ms per step of ``n_loop`` chained steps replayed from a CUDA
graph (``_timing``):

- ``iteration_ms``, ``iteration_tflops``: the full iteration,
  ``make_iteration(CalsParams(precision="high", force_max_iter=True,
  epilogue=..., mttkrp_precision=...))``, chained on its state; FLOPs by
  ``ops/mttkrp.als_iteration_flops``. Before it is timed, each fused
  MTTKRP of its held layouts is held against its plain version, and where
  its epilogue is the fused kernels, one step against the same step with
  ``epilogue="xla"``;
- ``mttkrp_m{mode}_{method}_{tier}``: the batched MTTKRP by krp_gemm and by
  the twostep, chained through the first non-target factor;
- with ``--components``, the update's pieces: ``update_cholesky_solve_ms``
  (the script's name; its solve is the default Gauss-Jordan, as in the
  script), ``gramian_ms`` at [B, I_1, R], ``normalize_ms`` at
  [B, I_0, R], and ``fast_error_df_ms``, the double-float FastALS error,
  at [B, I_2, R];
- the roofline probes: ``pure_matmul_{tier}``, [I_0, P] x [P, B R] through
  ``ops/mttkrp.tier_matmul``, and ``peak_bf16_4096``, a chain of bf16
  4096^3 products with float32 output (``torch.mm``; a yardstick, no
  kernel of the port).
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from ..config import CalsParams, resolve_epilogue
from ..device import resolve_device
from ..ktensor import Ktensor, normalize_mode
from ..ops.error import fast_error
from ..ops.gramians import gramian
from ..ops.mttkrp import PRECISIONS, als_iteration_flops, mttkrp_batched, mttkrp_flops, prepare_batched, tier_matmul
from ..ops.update import update_factor_unconstrained
from ..prng import normal
from ..solvers.iteration import make_iteration
from ..solvers.state import init_state
from . import _timing as tm


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", default="299-301-41")
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--rank", type=int, default=20)
    p.add_argument("--n-loop", type=int, default=20)
    p.add_argument("--reps", type=int, default=3, help="timed replays, the best kept (the script's reps)")
    p.add_argument("--out", default=tm.out_path("profile.json"))
    p.add_argument("--skip-peaks", action="store_true")
    p.add_argument("--skip-iteration", action="store_true")
    p.add_argument("--skip-mttkrp", action="store_true")
    p.add_argument("--components", action="store_true",
                   help="profile the update-path components (solve, gramian, normalize, df64 error)")
    p.add_argument("--precisions", default="high", help="comma list of MTTKRP tiers to profile")
    p.add_argument("--epilogue", default="auto", help="iteration epilogue: auto | fused | xla")
    p.add_argument("--mttkrp-precision", default=None, help="MTTKRP-only precision override")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, no times)")
    return p


def workload(modes, b: int, r: int, dev):
    """The script's draw: X, factors [B, I_m, R] x 0.1 and lam = 1, and the
    components' inputs G [B, I_1, R] and G_last [B, I_2, R]."""
    ks, x, factors = tm.draw(modes, b, r, len(modes) + 1, dev)
    kt = Ktensor(factors, torch.ones((b, r), device=dev))
    return x, kt, normal(ks[1], (b, modes[1], r)), normal(ks[2], (b, modes[-1], r))


def iteration_params(epilogue: str = "auto", mttkrp_precision: str | None = None) -> CalsParams:
    return CalsParams(precision="high", force_max_iter=True, max_iterations=10**9, epilogue=epilogue,
                      mttkrp_precision=mttkrp_precision)


def iteration_step(iteration, x, x_norm, prepared):
    return lambda s: iteration(x, s, x_norm, prepared)


def mttkrp_step(x, factors, mode: int, method: str, tier: str, prepared, weight: float = 1e-30):
    """One MTTKRP whose result is folded into the first non-target factor.
    ``weight`` (here and in the other steps) is how much of the step's
    result the chain carries: the script's, or 1 for a test to read it."""
    other = tm.first_other(x.ndim, mode)

    def step(fo):
        fs = factors[:other] + (fo,) + factors[other + 1:]
        g = mttkrp_batched(x, fs, mode, method, tier, prepared)
        return fo + torch.sum(g, dim=-2, keepdim=True) * weight

    return other, step


def update_step(h0):
    return lambda g: update_factor_unconstrained(g, h0) * 0.999 + 0.001


def gramian_step(weight: float = 1e-30):
    return lambda u: u + torch.sum(gramian(u), dim=-2)[..., None, :] * weight


def normalize_step(kt: Ktensor, iteration, weight: float = 1e-30):
    def step(f):
        kt3 = normalize_mode(Ktensor((f,) + kt.factors[1:], kt.lam), 0, iteration)
        return kt3.factors[0] + kt3.lam[..., :1, None] * weight

    return step


def error_step(x_norm, kt: Ktensor, gh, weight: float = 1e-30):
    return lambda gl: gl + fast_error(x_norm, kt.lam, kt.factors[-1], gl, gh)[..., None, None] * weight


def matmul_step(krp, tier: str, weight: float = 1e-30):
    return lambda a: a + torch.sum(tier_matmul(a, krp, tier), dim=1, keepdim=True) * weight


def peak_step(a16):
    def step(a):
        if a.is_cuda:
            g = torch.mm(a, a16, out_dtype=torch.float32)
        else:
            g = torch.mm(a.float(), a16.float())
        return a + (torch.sum(g, dim=1, keepdim=True) * 1e-30).to(torch.bfloat16)

    return step


def check_iteration(params: CalsParams, x, state0, x_norm, iteration, prepared) -> dict:
    """Before the iteration is timed: each fused MTTKRP of its held layouts
    against its plain version, and where its epilogue is fused, one step
    against one step of the same iteration with ``epilogue="xla"``."""
    tier = params.mttkrp_precision or params.precision
    out = {}
    for mode, method in enumerate(prepared.methods):
        if method == "pallas":
            _, out[f"mttkrp_m{mode}"] = tm.check_fused_mttkrp(f"iteration MTTKRP m{mode} {tier}", x, state0.kt.factors,
                                                              mode, prepared[mode], tier)
    if resolve_epilogue(params) == "fused":
        xla = make_iteration(replace(params, epilogue="xla"), batched=True)
        out["fused_vs_xla"] = tm.check_states("iteration fused vs xla", iteration(x, state0, x_norm, prepared),
                                              xla(x, state0, x_norm, xla.prepare(x)))
    return out


def run(args, checks: dict | None = None) -> dict:
    """The profile as ``main`` runs it; the kernels' readings against their
    plain versions go to ``checks`` (not into the script's keys)."""
    checks = {} if checks is None else checks
    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.modes.split("-"))
    b, r, n_loop, reps = args.batch, args.rank, args.n_loop, args.reps
    x, kt, g_comp, g_last = workload(modes, b, r, dev)
    x_norm = torch.linalg.vector_norm(x.reshape(-1))
    results = {"modes": modes, "batch": b, "rank": r, **tm.header(dev)}
    print(f"device: {results['device']} | modes {modes} batch {b} rank {r}", flush=True)

    def flush():
        tm.write(args.out, results)

    results["null_roundtrip_ms"] = tm.null_ms(dev)
    print(f"null dispatch+fetch round-trip: {tm.fmt(results['null_roundtrip_ms'])}", flush=True)
    flush()

    if not args.skip_iteration:
        params = iteration_params(args.epilogue, args.mttkrp_precision)
        iteration = make_iteration(params, batched=True)
        prepared = iteration.prepare(x)
        state0 = init_state(kt, x_norm)
        checks["iteration"] = check_iteration(params, x, state0, x_norm, iteration, prepared)
        t = tm.timed(iteration_step(iteration, x, x_norm, prepared), state0, n_loop, reps, dev)
        flops = als_iteration_flops(modes, r, b)
        results["iteration_ms"] = t
        results["iteration_tflops"] = tm.rate(flops, t)
        print(f"iteration: {tm.fmt(t)}", flush=True)
        flush()

    if not args.skip_mttkrp:
        for tier in args.precisions.split(","):
            if tier not in PRECISIONS:
                raise ValueError(f"precision {tier!r}: expected one of {PRECISIONS}")
            for mode in range(len(modes)):
                for method in ("krp_gemm", "twostep"):
                    prep = prepare_batched(x, (method,) * len(modes), tier)
                    other, step = mttkrp_step(x, kt.factors, mode, method, tier, prep[mode])
                    t = tm.timed(step, kt.factors[other], n_loop, reps, dev)
                    key = f"mttkrp_m{mode}_{method}_{tier}"
                    results[key] = {"ms": t, "tflops": tm.rate(mttkrp_flops(modes, r, mode, b), t)}
                    print(f"{key:38s} {tm.fmt(t)}", flush=True)
                    flush()

    if args.components:
        h0 = (torch.eye(r, device=dev) + 0.01 * torch.ones((r, r), device=dev)).expand(b, r, r)
        for key, step, carry, what in (
            ("update_cholesky_solve_ms", update_step(h0), g_comp, f"update (solve) [B,{modes[1]},{r}]"),
            ("gramian_ms", gramian_step(), g_comp, f"gramian [B,{modes[1]},{r}]"),
            ("normalize_ms", normalize_step(kt, torch.tensor(5, dtype=torch.int32, device=dev)), kt.factors[0],
             f"normalize_mode [B,{modes[0]},{r}]"),
            ("fast_error_df_ms", error_step(x_norm, kt, torch.eye(r, device=dev).expand(b, r, r)), g_last,
             f"fast_error (df64) [B,{modes[-1]},{r}]"),
        ):
            results[key] = tm.timed(step, carry, n_loop, reps, dev)
            print(f"{what}: {tm.fmt(results[key])}", flush=True)
            flush()

    if not args.skip_peaks:
        p_ = int(np.prod(modes[1:]))
        xu = torch.from_numpy(np.random.default_rng(0).normal(size=(modes[0], p_)).astype(np.float32)).to(dev)
        krp = torch.from_numpy(np.random.default_rng(1).normal(size=(p_, b * r)).astype(np.float32)).to(dev)
        for tier in ("high", "highest", "default"):
            t = tm.timed(matmul_step(krp, tier), xu, n_loop, reps, dev)
            results[f"pure_matmul_{tier}"] = {"ms": t, "tflops": tm.rate(2 * modes[0] * p_ * b * r, t)}
            print(f"pure_matmul [{modes[0]},{p_}]x[{p_},{b * r}] {tier}: {tm.fmt(t)}", flush=True)
            flush()
        del xu, krp
        a16 = torch.from_numpy(np.random.default_rng(2).normal(size=(4096, 4096)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        t = tm.timed(peak_step(a16), a16, n_loop, reps, dev)
        results["peak_bf16_4096"] = {"ms": t, "tflops": tm.rate(2 * 4096**3, t)}
        print(f"peak bf16 4096^3: {tm.fmt(t)}", flush=True)

    flush()
    print(f"wrote {args.out}")
    return results


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
