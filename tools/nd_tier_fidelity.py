#!/usr/bin/env python3
"""Dense fits of the 4-D bench workload's models by MTTKRP route and tier.

    python3 tools/nd_tier_fidelity.py [--device cuda|cpu]

Runs one model per bucket (ranks 4, 8, 12, 16, 20) of chip_smoke.py's 4-D
workload (the bench tensor with a fourth mode of 8, 10 forced iterations)
through ``cp_cals`` with the MTTKRP as the twostep at "highest", "high" and
"default", and as krp_gemm at "default", and prints each model's fit from
its dense reconstruction beside the fit the engine reported (the FastALS
error of the run's own MTTKRP). Writes chiprun_out/nd_tier_fidelity.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the 4-D workload and its settings)

RUNS = {
    "twostep highest": dict(mttkrp_method="twostep"),
    "twostep high": dict(mttkrp_method="twostep", precision="high", mttkrp_precision="high"),
    "twostep default": dict(mttkrp_method="twostep", **chip_smoke.BENCH_TIERS),
    "krp_gemm default": dict(mttkrp_method="krp_gemm", **chip_smoke.BENCH_TIERS),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    from cp_cals_tpu_torch import MttkrpMethod, cp_cals

    x_np, rng = chip_smoke.bench_tensor(chip_smoke.MODES4)
    queue = chip_smoke.engine_queue(rng, chip_smoke.MODES4)
    models = [queue[20 * (r - 1)] for r in chip_smoke.BUCKETS]
    x64 = x_np.astype(np.float64)
    xn = np.linalg.norm(x64)
    out = {}
    for name, kw in RUNS.items():
        kw = dict(kw, mttkrp_method=MttkrpMethod(kw["mttkrp_method"]))
        results, rep = cp_cals(x_np, models, chip_smoke.bench_params(**kw), device=args.device)
        out[name] = [dict(rank=m.rank, dense_fit=float(1 - np.linalg.norm(x64 - chip_smoke.dense(k)) / xn),
                          reported_fit=float(m.fit)) for k, m in zip(results, rep.models)]
        print(f"{name}: " + ", ".join(f"R={d['rank']} {d['dense_fit']:.4f} (reported {d['reported_fit']:.4f})"
                                      for d in out[name]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "nd_tier_fidelity.json"), "w") as fh:
        json.dump(dict(device=args.device, runs=out), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
