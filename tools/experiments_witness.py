#!/usr/bin/env python3
"""Two readings of the experiment harness (cp_cals_tpu_torch/experiments.py)
on the card.

    python3 tools/experiments_witness.py [--skip-nnls] [--skip-profile] [--bucket-threads 4]

1. The NNLS comparison at full size (``experiments.nnls_workload``: 100^3,
   100 models of ranks 1-10, 50 forced iterations at "high", block
   principal pivoting): CALS and per-rank batched ALS on the card, each
   model's error on both sides and the models the harness's check
   (``compare_als_cals``: |e_cals - e_als| <= 0.1 max(1, |e_als|)) counts as
   mismatched. The same comparison again on the CPU from the card's target
   and the same inits, in float32 (the same packings and tier rule) and in
   float64, where the two sides compute the same function but for rounding.
2. The 500^3 scale sweep as chip_smoke.py cuts it (``chip_smoke.EXP_SWEEP``)
   and its engine call again under torch.profiler: the device's busy share
   of the wall and its time by kernel, so the layouts the loop derives each
   iteration ("recompute": X rounded to bf16 hi and lo planes in the fused
   kernels' layout) show beside the MTTKRP. The sweep's engine call runs at
   each ``--bucket-threads`` count (a comma list, default 1, the engine's),
   one after another, each with its peak allocated bytes
   (``hbm_measured``).

Writes chiprun_out/experiments_witness.json. Needs a CUDA card.
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

import chip_smoke  # noqa: E402  (card_line, profiled, EXP_SWEEP)
from cp_cals_tpu_torch import Ktensor, cp_batched_als, cp_cals, experiments  # noqa: E402

CHECK_TOL = 1e-1  # compare_als_cals's default


def nnls_errors(x, queue, cals_params, als_params, dev) -> tuple[dict, dict]:
    """{model id: error} of CALS over the whole queue and of batched ALS per
    rank, as ``compare_als_cals`` runs them."""
    _, rep = cp_cals(x, queue, cals_params, device=dev)
    cals = {m.id: m.approx_error for m in rep.models}
    als = {}
    for r in sorted({kt.rank for kt in queue}):
        idx = [i for i, kt in enumerate(queue) if kt.rank == r]
        _, reps = cp_batched_als(x, [queue[i] for i in idx], als_params, device=dev)
        als.update({i: rr.approx_error for i, rr in zip(idx, reps)})
    return cals, als


def mismatched(cals: dict, als: dict) -> list:
    return [i for i in cals if not abs(cals[i] - als[i]) <= CHECK_TOL * max(1.0, abs(als[i])) or cals[i] != cals[i]]


def nnls_reading(dev) -> dict:
    x, queue, cals_params, als_params = experiments.nnls_workload(False, dev)
    out = {"x_norm": float(torch.linalg.vector_norm(x.double()))}
    runs = {"card float32": (x, queue, dev)}
    x_cpu = x.cpu()
    for name, dt in (("cpu float32", np.float32), ("cpu float64", np.float64)):
        q = [Ktensor(tuple(f.astype(dt) for f in kt.factors), kt.lam.astype(dt)) for kt in queue]
        runs[name] = (x_cpu.to(torch.float64 if dt == np.float64 else torch.float32), q, "cpu")
    errors = {}
    for name, (xx, q, d) in runs.items():
        t0 = time.perf_counter()
        cals, als = nnls_errors(xx, q, cals_params, als_params, d)
        bad = mismatched(cals, als)
        gaps = {i: abs(cals[i] - als[i]) for i in cals}
        errors[name] = (cals, als)
        out[name] = dict(seconds=time.perf_counter() - t0, n_mismatched=len(bad), mismatched=bad,
                         max_gap=max(gaps.values()), largest_gaps=sorted(gaps, key=gaps.get, reverse=True)[:5])
        print(f"NNLS {name}: {len(bad)} mismatched {bad}, largest |e_cals - e_als| {out[name]['max_gap']:.4g} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    watch = sorted(set(out["card float32"]["mismatched"]) | set(out["card float32"]["largest_gaps"]))
    out["models"] = {str(i): dict(rank=queue[i].rank, **{name: dict(cals=errors[name][0][i], als=errors[name][1][i])
                                                          for name in runs}) for i in watch}
    for i in watch:
        print(f"  model {i} (rank {queue[i].rank}): " + "; ".join(
            f"{name} cals {errors[name][0][i]:.6g} als {errors[name][1][i]:.6g}" for name in runs), flush=True)
    return out


def profile_reading(dev, threads: int = 4) -> dict:
    """The cut 500^3 sweep once (which warms the build, the tables and the
    allocator), its engine call at ``threads`` bucket threads captured; then
    that call again under torch.profiler (the tensor's host draw left
    out)."""
    import dataclasses

    from cp_cals_tpu_torch import solvers

    call, real = {}, solvers.cp_cals

    def grab(x, queue, params, *a, **kw):
        params = dataclasses.replace(params, bucket_threads=threads)
        call.update(x=x, queue=queue, params=params)
        return real(x, queue, params, *a, **kw)

    solvers.cp_cals = grab
    try:
        sweep = experiments.scale_sweep(device=dev, **chip_smoke.EXP_SWEEP)
    finally:
        solvers.cp_cals = real
    prof = chip_smoke.profiled(lambda: cp_cals(call["x"], call["queue"], call["params"], device=dev))
    prof["sweep"] = sweep
    print(f"500^3 sweep {chip_smoke.EXP_SWEEP} at bucket_threads={threads}: {sweep}", flush=True)
    print(f"its engine call profiled: wall {prof['wall_s']:.3f}s, device busy {prof['busy_ms']:.1f} ms "
          f"(share {prof['busy_share']:.3f}), {prof['kernels']} kernels", flush=True)
    for name, ms in prof["kernel_ms"].items():
        print(f"  {ms:9.2f} ms  {name}", flush=True)
    return prof


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--skip-nnls", action="store_true")
    p.add_argument("--skip-profile", action="store_true")
    p.add_argument("--bucket-threads", default="1", help="comma list of the sweep's bucket_threads counts")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    out = {"card": chip_smoke.card_line()}
    print(out["card"], flush=True)
    if not args.skip_nnls:
        out["nnls"] = nnls_reading(dev)
    if not args.skip_profile:
        out["sweep_profile"] = {t: profile_reading(dev, int(t)) for t in args.bucket_threads.split(",")}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "experiments_witness.json"), "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
