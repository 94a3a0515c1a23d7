#!/usr/bin/env python3
"""What a process's first ``cp_cals`` pays for after ``precompile_buckets``.

    python3 tools/first_call.py [--tiers bench|highest] [--calls N] [--no-eager]

In a fresh process on the card: ``precompile_buckets`` on the bench
workload of chip_smoke.py (299x301x41, 400 models of ranks 1-20,
buckets 4/8/12/16/20, buffer_size=2880, 10 forced iterations), timed,
then N ``cp_cals`` calls (default 4) of the same arguments, each timed
(host clock around a synchronised call) with its phase times summed over
buckets. The first call's excess over the later ones is what a warm-up
could still remove. ``--no-eager`` leaves out precompile_buckets' eager
iteration of every bucket's program (``solvers/cals.py:_warm_programs``),
to show what it takes on itself. Prints one JSON line and writes it to
chiprun_out/first_call_<tiers>[_no_eager].json. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench workload and its settings)

TIERS = {"bench": chip_smoke.BENCH_TIERS, "highest": {}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiers", choices=sorted(TIERS), default="bench")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--no-eager", action="store_true", help="precompile_buckets without its eager iterations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("first_call: CUDA is not available", file=sys.stderr)
        return 2
    from cp_cals_tpu_torch import cp_cals
    from cp_cals_tpu_torch.solvers import cals

    if args.no_eager:
        cals._warm_programs = lambda *a, **k: None

    card = chip_smoke.card_line()
    print(card, flush=True)
    x_np, rng = chip_smoke.bench_tensor()
    queue = chip_smoke.engine_queue(rng)
    params = chip_smoke.bench_params(**TIERS[args.tiers])
    t0 = time.perf_counter()
    cals.precompile_buckets(x_np, queue, params)
    torch.cuda.synchronize()
    out = dict(card=card, tiers=args.tiers, eager=not args.no_eager, precompile_s=time.perf_counter() - t0, calls=[])
    for _ in range(args.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = cp_cals(x_np, queue, params)
        torch.cuda.synchronize()
        phases = collections.Counter()
        for pt in rep.phase_times.values():
            phases.update(pt)
        out["calls"].append(dict(wall_s=time.perf_counter() - t0, phases=dict(phases)))
        print(f"call {len(out['calls'])}: wall {out['calls'][-1]['wall_s']:.4f}s, "
              + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"first_call_{args.tiers}{'_no_eager' if args.no_eager else ''}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
