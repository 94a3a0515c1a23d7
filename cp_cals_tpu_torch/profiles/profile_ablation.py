"""Cumulative ablation of the CALS iteration body on the card (the
counterpart of ``scripts/profile_ablation.py``: its flags and keys).

    python -m cp_cals_tpu_torch.profiles.profile_ablation [--modes 299-301-41]
        [--batch 96] [--rank 20] [--n-loop 20] [--precision high]
        [--apply-precision TIER] [--device cuda]
        [--out chiprun_out/profiles/ablation.json]

The loop body grows stage by stage, all in one process: 1 the three
twostep MTTKRPs alone (``mttkrp_only_ms``), 2 plus the solve
(``plus_solve_ms``), 3 plus the normalization and gramian
(``plus_norm_gram_ms``), 4 plus the FastALS error (``full_with_error_ms``).
The differences between stages are the phases' costs. Each time is ms per
step replayed from a CUDA graph (``_timing``), so no host round trip is in
it and none is subtracted.

``--precision`` is the MTTKRP's tier. ``--apply-precision`` (given) runs
the product U = G H^-1 through ``ops/mttkrp.tier_matmul`` at that tier;
without it the update is ``ops/update.update_factor_unconstrained``, strict
float32, where the script applies at ``--precision``: the port's tiers act
on the MTTKRP only. The unfused path throughout: no kernel of the port
launches.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ktensor import normalize_factor_fused
from ..ops.error import fast_error
from ..ops.gramians import gramians, hadamard_all, hadamard_but_one
from ..ops.mttkrp import mttkrp_batched, prepare_batched, tier_matmul
from ..ops.update import gj_inverse, padded_hadamard, update_factor_unconstrained
from . import _timing as tm

NAMES = {1: "mttkrp_only", 2: "plus_solve", 3: "plus_norm_gram", 4: "full_with_error"}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", default="299-301-41")
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--rank", type=int, default=20)
    p.add_argument("--n-loop", type=int, default=20)
    p.add_argument("--reps", type=int, default=4, help="timed replays, the best kept (the script's reps)")
    p.add_argument("--precision", default="high")
    p.add_argument("--apply-precision", default=None, help="tier of the solve's product U = G H^-1")
    p.add_argument("--out", default=tm.out_path("ablation.json"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, no times)")
    return p


def solve(g, h, apply_precision: str | None):
    """U = G H^-1: the port's update, or with ``apply_precision`` the
    Gauss-Jordan inverse applied through ``tier_matmul`` at that tier."""
    if apply_precision is None:
        return update_factor_unconstrained(g, h)
    return tier_matmul(g, gj_inverse(h), apply_precision)


def stage_step(stage: int, x, x_norm, prepared, mask, iters, precision: str, apply_precision: str | None):
    """One step of the body of ``stage`` on the carry (factors, lam,
    gramians, error accumulator), composed as the script composes it."""
    n_modes = x.ndim

    def step(carry):
        fs, lam, grams, acc = carry
        g_last = None
        for n in range(n_modes):
            g = mttkrp_batched(x, fs, n, "twostep", precision, prepared[n])
            if n == n_modes - 1:
                g_last = g
            if stage == 1:  # consume g, keep the factors evolving slightly
                fs = tuple(f if m != n else f * 0.999 + g * 1e-12 for m, f in enumerate(fs))
                continue
            h = padded_hadamard(hadamard_but_one(grams, n), mask)
            u = solve(g, h, apply_precision)
            if stage == 2:
                fs = tuple(f if m != n else u * 1e-12 + f * 0.999 for m, f in enumerate(fs))
                continue
            f_new, lam, gm = normalize_factor_fused(u, iters)
            fs = tuple(f_new if m == n else f for m, f in enumerate(fs))
            grams = tuple(gm if m == n else gg for m, gg in enumerate(grams))
        if stage >= 4:
            err = fast_error(x_norm, lam, fs[-1], g_last, hadamard_all(grams))
            acc = acc + torch.sum(err) * 1e-20
        return fs, lam, grams, acc

    return step


def initial_carry(factors, lam0):
    return factors, lam0, gramians(factors), torch.zeros((), dtype=lam0.dtype, device=lam0.device)


def run(args) -> dict:
    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.modes.split("-"))
    b, r, n_loop = args.batch, args.rank, args.n_loop
    _, x, factors = tm.draw(modes, b, r, len(modes) + 1, dev)
    lam0 = torch.ones((b, r), device=dev)
    x_norm = torch.linalg.vector_norm(x.reshape(-1))
    mask = torch.ones((b, r), dtype=torch.bool, device=dev)
    iters5 = torch.full((b,), 5, dtype=torch.int32, device=dev)
    prepared = prepare_batched(x, ("twostep",) * len(modes), args.precision)
    head = tm.header(dev)
    print(f"device: {head['device']} modes {modes} B={b} R={r} prec={args.precision} "
          f"apply={args.apply_precision}", flush=True)
    res = {"null_ms": tm.null_ms(dev), "precision": args.precision, "apply_precision": args.apply_precision,
           **head}
    print(f"null {tm.fmt(res['null_ms'])}", flush=True)
    prev = None
    for stage in (1, 2, 3, 4):
        step = stage_step(stage, x, x_norm, prepared, mask, iters5, args.precision, args.apply_precision)
        t = tm.timed(step, initial_carry(factors, lam0), n_loop, args.reps, dev)
        res[NAMES[stage] + "_ms"] = t
        more = "" if t is None or prev is None else f"  (+{t - prev:6.4f})"
        print(f"{NAMES[stage]:18s} {tm.fmt(t)}{more}", flush=True)
        prev = t
    tm.write(args.out, res)
    print("wrote", args.out)
    return res


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
