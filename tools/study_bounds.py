#!/usr/bin/env python3
"""The CPU readings that set the limits of chip_smoke.py's studies phase.

    python3 tools/study_bounds.py [--threads N]

Runs the studies phase's float32 legs (chip_smoke.study_fp32) on the CPU,
through the kernels' plain versions, at the phase's full width, and reads
them against the JAX package's committed float64 oracles as the phase reads
the card's: convergence_run's three configurations, jk_fidelity_study's
f32_high, f32_high_xla and f32_default_polish_conv bands (299 replicates),
bench_tol's float32 leg (400 models) and bench_external_cpd's float32 row.
STUDY_BOUNDS in chip_smoke.py is each reading times 10, rounded up to one
significant digit; this prints those limits beside the readings. The
MTTKRP results by route of each run are checked as on the card (the CPU
counts no kernel launch). Writes chiprun_out/study_bounds.json. About a
minute on 6 CPU threads.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402  (the studies' legs, settings and readings)


def limit(reading: float) -> float:
    """``reading`` times 10, rounded up to one significant digit."""
    if reading <= 0:
        return 0.0
    v = 10 * reading
    scale = 10.0 ** math.floor(math.log10(v))
    return math.ceil(v / scale) * scale


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    fp32 = c.study_fp32(torch.device("cpu"))
    c.study_lines(fp32)
    bounds = {}
    for name, keys in c.STUDY_BOUNDS.items():
        bounds[name] = {}
        for key in keys:
            got = fp32[name][key]
            if isinstance(got, list):
                bounds[name][key] = [limit(v) for v in got]
            else:
                bounds[name][key] = limit(got)
            print(f"{name} {key}: CPU {got} -> limit {bounds[name][key]}")
    readings = {name: {k: v for k, v in d.items() if k != "rows"} for name, d in fp32.items()}
    out = dict(device="cpu", threads=torch.get_num_threads(), readings=readings, bounds=bounds,
               seconds=time.perf_counter() - t0)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "study_bounds.json"), "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    print(f"{out['seconds']:.1f}s on the CPU ({out['threads']} threads); chiprun_out/study_bounds.json")
    return out


if __name__ == "__main__":
    main()
