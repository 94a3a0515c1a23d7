#!/usr/bin/env python3
"""The CPU readings that set the limits of chip_smoke.py's stress phase.

    python3 tools/stress_bounds.py [--copies N] [--threads N]

Runs the stress phase's float32 legs on the CPU (the kernels' plain
versions, "highest") beside the float64 CPU run of the same settings, and
reads them as the phase reads the card's (chip_smoke.s2_readings,
chip_smoke.s3_reading): S2, the 360 models (30 of each rank 1-12, or
``--copies`` of each) through cp_cals, cp_als and cp_batched_als with 30
forced iterations, against the float64 cp_cals run and against each
other; S3, jk_cp_cals of the reference-scale jackknife in float32 against
float64. STRESS_CROSS_TOL and JK_STRESS_CROSS_TOL in chip_smoke.py are
these readings with headroom for the card's other summation orders. Writes
chiprun_out/stress_bounds.json. About 4.5 minutes at the default
size on 8 CPU threads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402  (the stress workloads, settings and readings)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--copies", type=int, default=c.STRESS_COPIES, help="models of each rank 1-12")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    from cp_cals_tpu_torch import CalsParams, jk_cp_cals

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    x, ranks, kts = c.stress_workload(args.copies)
    ref = c.stress_paths(x, ranks, kts, c.STRESS_FORCED, cpu, paths=("cp_cals",))["cp_cals"]
    x32, kts32 = c.as_float32(x, kts)
    runs = c.stress_paths(x32, ranks, kts32, c.STRESS_FORCED, cpu, precision="highest")
    s2 = c.s2_readings(runs, ref, float(np.linalg.norm(x)))
    walls = {p: r["wall_s"] for p, r in runs.items()}

    xj, fitted = c.jk_stress_problem(cpu)
    jk64 = jk_cp_cals(xj, fitted, CalsParams(**c.JK_STRESS, **c.JK_STRESS_ENGINE, **c.pinned()), device=cpu)
    xj32, fitted32 = c.as_float32(xj, fitted)
    jk32 = jk_cp_cals(xj32, fitted32, CalsParams(**c.JK_STRESS, **c.JK_STRESS_ENGINE, precision="highest",
                                                 **c.pinned()), device=cpu)
    s3 = c.s3_reading(jk32, jk64, float(np.linalg.norm(xj)))

    for k, d in s2.items():
        print(f"S2 {k}: max |fit diff| {d['max_fit_diff']:.3e}, max reconstruction diff / |X| "
              f"{d['max_recon_diff']:.3e}")
    print(f"S3 float32 jk_cp_cals vs float64: max reconstruction diff / |X| {s3:.3e}")
    out = dict(device="cpu", threads=torch.get_num_threads(), copies=args.copies, s2=s2,
               s3_float32_vs_float64=s3, s2_walls_s=walls, seconds=time.perf_counter() - t0)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "stress_bounds.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"{out['seconds']:.1f}s on the CPU ({out['threads']} threads); chiprun_out/stress_bounds.json")
    return out


if __name__ == "__main__":
    main()
