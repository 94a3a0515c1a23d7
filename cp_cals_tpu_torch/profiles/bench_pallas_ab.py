"""Interleaved A/B of the twostep against the fused MTTKRP kernel on the
card (the counterpart of ``scripts/bench_pallas_ab.py``: its positional
command line and its modes).

    python -m cp_cals_tpu_torch.profiles.bench_pallas_ab [R] [B] [reps] [prec]
        [--device cuda] [--out chiprun_out/profiles/bench_pallas_ab.json]

Defaults: R = 20, B = 96, 7 reps, "high", on 299x301x41. Per mode, the
twostep (``ops/mttkrp.mttkrp_batched``) and the fused kernel of the tier
(``ops/fused_mttkrp.mttkrp_batched_fused`` on ``prepare_mode_tensor(x,
mode, tier)``), each ``N_LOOP`` chained steps replayed from a CUDA graph
(``_timing``), timed in turns within each rep; the best of each and the
median, min and max of the per-rep ratio twostep / fused. The script only
prints; the port also writes the numbers as JSON. The fused kernel is held
against its plain version on the same inputs before it is timed.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device
from ..ops.fused_mttkrp import mttkrp_batched_fused, prepare_mode_tensor
from ..ops.mttkrp import mttkrp_batched, prepare_batched
from . import _timing as tm

MODES = (299, 301, 41)
N_LOOP = 20
VARIANTS = ("twostep", "fused")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rank", nargs="?", type=int, default=20)
    p.add_argument("batch", nargs="?", type=int, default=96)
    p.add_argument("reps", nargs="?", type=int, default=7)
    p.add_argument("prec", nargs="?", default="high")
    p.add_argument("--out", default=tm.out_path("bench_pallas_ab.json"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, no times)")
    return p


def make_step(x, mode: int, variant: str, tier: str, weight: float = 1e-20):
    """(the mode's layout, one step): the MTTKRP by ``variant`` folded into
    the first non-target factor of the carried factors, times ``weight``
    (the script's, or 1 for a test to read it)."""
    other = tm.first_other(x.ndim, mode)
    if variant == "twostep":
        prepared = prepare_batched(x, ("twostep",) * x.ndim, tier)[mode]

        def call(f):
            return mttkrp_batched(x, f, mode, "twostep", tier, prepared)
    else:
        prepared = prepare_mode_tensor(x, mode, tier)

        def call(f):
            return mttkrp_batched_fused(x, f, mode, prepared, tier)

    def step(f):
        fo = f[other] + call(f).sum(dim=-2, keepdim=True) * weight
        return f[:other] + (fo,) + f[other + 1:]

    return prepared, step


def run(args, checks: dict | None = None) -> dict:
    """The A/B as ``main`` runs it; the fused kernel's readings against its
    plain version go to ``checks``."""
    checks = {} if checks is None else checks
    dev = resolve_device(args.device)
    modes = MODES
    r, b, reps, tier = args.rank, args.batch, args.reps, args.prec
    _, x, factors = tm.draw(modes, b, r, 4, dev, scale=None)
    flops = 2 * int(np.prod(modes)) * b * r
    res = {"modes": modes, "rank": r, "batch": b, "reps": reps, "precision": tier, "n_loop": N_LOOP,
           **tm.header(dev), "null_roundtrip_ms": tm.null_ms(dev), "results": []}
    for mode in range(len(modes)):
        chains = {}
        for v in VARIANTS:
            prepared, step = make_step(x, mode, v, tier)
            if v == "fused":
                _, checks[f"m{mode}"] = tm.check_fused_mttkrp(f"fused MTTKRP m{mode} {tier}", x, factors, mode,
                                                              prepared, tier)
            chains[v] = tm.Chain(step, factors, N_LOOP, dev)
        best = {v: None for v in VARIANTS}
        ratios = []
        for _ in range(reps):
            t = {v: chains[v].once() for v in VARIANTS}  # in turns
            if t["fused"] is not None:
                best = {v: t[v] if best[v] is None else min(best[v], t[v]) for v in VARIANTS}
                ratios.append(t["twostep"] / t["fused"])
        row = {"mode": mode, "twostep_ms": best["twostep"], "fused_ms": best["fused"],
               "twostep_tflops": tm.rate(flops, best["twostep"]), "fused_tflops": tm.rate(flops, best["fused"]),
               "ratio_median": float(np.median(ratios)) if ratios else None,
               "ratio_min": min(ratios) if ratios else None, "ratio_max": max(ratios) if ratios else None,
               "ratios": ratios}
        res["results"].append(row)
        if ratios:
            print(f"mode={mode} prec={tier}: twostep {best['twostep']:.4f} ms ({row['twostep_tflops']:.1f} TF/s) | "
                  f"fused {best['fused']:.4f} ms ({row['fused_tflops']:.1f} TF/s) | ratio med "
                  f"{row['ratio_median']:.3f} [{row['ratio_min']:.3f}..{row['ratio_max']:.3f}]", flush=True)
        else:
            print(f"mode={mode} prec={tier}: not timed (cpu)", flush=True)
        del chains
    tm.write(args.out, res)
    print(f"wrote {args.out}")
    return res


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
