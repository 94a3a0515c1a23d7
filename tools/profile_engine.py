#!/usr/bin/env python3
"""Trace the port's cp_cals on the bench workload with torch.profiler.

    python3 tools/profile_engine.py [--tiers bench|highest] [--out DIR]

Runs the bench workload of chip_smoke.py (299x301x41, 400 models of ranks
1-20 x 20, buckets 4/8/12/16/20, buffer_size=2880, 10 forced iterations)
once to warm up and once under torch.profiler, then prints the wall time,
the device busy share (union of the CUDA kernel intervals over the wall),
device kernels per bucket-iteration, the device time and count of
PyTorch's elementwise kernels (all, and those on float data), the device
time of the normal inverse and by kernel name, and writes the summary and
a Chrome trace to DIR (default chiprun_out/). A third run is profiled on the host only, with
Python stacks, to count the PyTorch ops issued from ops/error.py (the
compensated error's elementwise ops, which the fused path leaves to the
apply kernel). Needs a CUDA card.
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


def union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiers", choices=sorted(TIERS), default="bench")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_engine: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from cp_cals_tpu_torch import cp_cals

    card = chip_smoke.card_line()
    x, rng = chip_smoke.bench_tensor()
    queue = chip_smoke.engine_queue(rng)
    params = chip_smoke.bench_params(**TIERS[args.tiers])
    cp_cals(x, queue, params)  # warm-up: kernel build, cuBLAS and allocator state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rep = cp_cals(x, queue, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    count = collections.Counter()
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s, d = e.time_range.start, e.time_range.elapsed_us()
            intervals.append((s, s + d))
            by_name[e.name] += d
            count[e.name] += 1
    busy_us = union_us(intervals)
    top = [dict(name=n[:120], ms=us / 1e3, calls=count[n]) for n, us in by_name.most_common(20)]
    elementwise = [n for n in by_name if "elementwise" in n]
    elementwise_f32 = [n for n in elementwise if "float" in n]
    bucket_iters = sum(rep.engine_iterations.values())

    # The same run again, host side only, with Python stacks: which ops came
    # from the compensated error of ops/error.py.
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof_stack:
        cp_cals(x, queue, params)
        torch.cuda.synchronize()
    error_ops = sum(1 for e in prof_stack.events()
                    if e.name.startswith("aten::") and any("ops/error.py" in f for f in (e.stack or ())))
    summary = dict(
        card=card, tiers=args.tiers, wall_s=wall, models_per_s=len(queue) / wall,
        device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / 1e6 / wall,
        kernels_launched=len(intervals), bucket_iterations=bucket_iters,
        kernels_per_bucket_iteration=len(intervals) / bucket_iters,
        elementwise_ms=sum(by_name[n] for n in elementwise) / 1e3,
        elementwise_launches=sum(count[n] for n in elementwise),
        elementwise_f32_ms=sum(by_name[n] for n in elementwise_f32) / 1e3,
        elementwise_f32_launches=sum(count[n] for n in elementwise_f32),
        error_py_ops=error_ops,
        # the normal inverse under either kernel name (hinv_kernel before
        # csrc/gj_elim.cuh, then gj_warp_kernel / gj_block_kernel with HadamardLoad)
        normal_inverse_ms=sum(us for n, us in by_name.items() if "hinv_kernel" in n or "HadamardLoad" in n) / 1e3,
        top=top,
    )
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, f"profile_engine_{args.tiers}.trace.json.gz"))
    with open(os.path.join(args.out, f"profile_engine_{args.tiers}.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(card)
    print(f"wall {wall:.4f}s ({summary['models_per_s']:.1f} models/s), device busy "
          f"{summary['device_busy_ms']:.2f} ms = {summary['device_busy_share']:.3f} of wall, "
          f"{len(intervals)} device kernels, {summary['kernels_per_bucket_iteration']:.1f} per "
          f"bucket-iteration ({bucket_iters}); elementwise {summary['elementwise_ms']:.2f} ms in "
          f"{summary['elementwise_launches']} launches (float: {summary['elementwise_f32_ms']:.2f} ms in "
          f"{summary['elementwise_f32_launches']}); ops from ops/error.py: {error_ops}; normal inverse "
          f"{summary['normal_inverse_ms']:.3f} ms")
    for t in top:
        print(f"  {t['ms']:9.3f} ms  {t['calls']:6d}  {t['name']}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
