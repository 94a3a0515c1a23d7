#!/usr/bin/env python3
"""Trace the port's cp_cals on the bench workload with torch.profiler, in
both bucket loops, and time the loop policies of the jackknife.

    python3 tools/profile_engine.py [--tiers bench|highest] [--out DIR] [--pairs N]
                                    [--bucket-threads 1,4]

Runs the bench workload of chip_smoke.py (299x301x41, 400 models of ranks
1-20 x 20, buckets 4/8/12/16/20, buffer_size=2880, 10 forced iterations)
through the device-paced graph loop (``sync_mode="evict"``) and the
per-iteration loop (``sync_mode="iter"``), at each ``--bucket-threads``
count in turns (default 1, the engine's; "1,4" profiles the serial and
the threaded engine): each once to warm up, once timed alone and once
under torch.profiler (``profile_run``). For each it prints the
wall times (alone and profiled), the device
busy share (union of the CUDA kernel intervals over the wall), device
kernels per bucket-iteration, the host-to-device copy time, graph replays
and stats fetches per bucket-iteration, the host's time in launch calls
(cudaLaunchKernel, cudaGraphLaunch, ...) apart from its time waiting in
synchronising calls, the device time and count of PyTorch's elementwise
kernels, the device time of the normal inverse and by kernel name, and
writes the summary and a Chrome trace to DIR (default chiprun_out/). Then
every (loop, thread count) unprofiled in N rounds of turns (default 10):
each one's median wall and range, and per round the wall ratios iter /
graph and threaded / serial. A last run of the
graph loop is profiled on the host only, with Python stacks, to count the
PyTorch ops issued from ops/error.py.

Then the loop policies (``solvers/graph_loop.py``), each timed on the
bench's jackknife (299 replicates of chip_smoke.py's rank-5 model; one
warm-up, then three runs in turns, the median wall): J1 (per-iteration
tol) at chunk lengths 1, 2, 4 and 8, and
J4 (the --fast tier: checks every 5, polish to 1e-6 in at most 25 sweeps)
with the host reading the polish's done flags every 4 sweeps, or never
(all 25 capped sweeps under the done select). Last, torch.linalg.inv_ex,
the inverses' yardstick, eager and replayed from a CUDA graph at the
bench-tier mix's shapes and J2's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench workload and its settings)

TIERS = {"bench": chip_smoke.BENCH_TIERS, "highest": {}}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
              "cudaStreamWaitEvent")


def profile_run(x, queue, params):
    """One run of ``params`` under torch.profiler: (the profiler, the
    run's report, its summary: the wall, the device's busy time (the union
    of the CUDA kernels' intervals, over every stream) and share of the
    wall, kernels, the host's time in launch calls and in synchronising
    calls, ...)."""
    from torch.profiler import ProfilerActivity, profile

    from cp_cals_tpu_torch import cp_cals

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rep = cp_cals(x, queue, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, count = collections.Counter(), collections.Counter()
    host = collections.Counter()
    intervals, h2d_us = [], 0.0
    for e in prof.events():
        d = e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "HtoD" in e.name:
                h2d_us += d
            if "Memcpy" in e.name or "Memset" in e.name:
                continue
            s = e.time_range.start
            intervals.append((s, s + d))
            by_name[e.name] += d
            count[e.name] += 1
        elif e.name in LAUNCH_CALLS or e.name in SYNC_CALLS:
            host[e.name] += d
    busy_us = chip_smoke.union_us(intervals)
    bucket_iters = sum(rep.engine_iterations.values())
    loop = chip_smoke.loop_totals(rep)
    elementwise = [n for n in by_name if "elementwise" in n]
    summary = dict(
        sync_mode=params.sync_mode, bucket_threads=params.bucket_threads, wall_s=wall,
        models_per_s=len(queue) / wall,
        device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / 1e6 / wall,
        h2d_ms=h2d_us / 1e3, kernels_launched=len(intervals), bucket_iterations=bucket_iters,
        kernels_per_bucket_iteration=len(intervals) / bucket_iters,
        replays_per_bucket_iteration=loop["replays"] / bucket_iters,
        stats_fetches_per_bucket_iteration=loop["stats_fetches"] / bucket_iters,
        captures=loop["captures"], capture_s=sum(pt["capture"] for pt in rep.phase_times.values()),
        host_launch_ms=sum(host[n] for n in LAUNCH_CALLS) / 1e3,
        host_sync_ms=sum(host[n] for n in SYNC_CALLS) / 1e3,
        host_calls={n: dict(ms=us / 1e3) for n, us in host.items()},
        elementwise_ms=sum(by_name[n] for n in elementwise) / 1e3,
        elementwise_launches=sum(count[n] for n in elementwise),
        # the normal inverse under its kernel names (gj_warp_kernel /
        # gj_block_kernel with HadamardLoad)
        normal_inverse_ms=sum(us for n, us in by_name.items() if "hinv_kernel" in n or "HadamardLoad" in n) / 1e3,
        top=[dict(name=n[:120], ms=us / 1e3, calls=count[n]) for n, us in by_name.most_common(20)],
    )
    return prof, rep, summary


def trace(x, queue, params, out_dir: str, label: str) -> dict:
    """One profiled run of ``params`` after a warm-up and an unprofiled
    run; the summary."""
    from cp_cals_tpu_torch import cp_cals

    cp_cals(x, queue, params)  # warm-up: kernel build, cuBLAS and allocator state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp_cals(x, queue, params)  # the same run without the profiler's cost
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    prof, rep, summary = profile_run(x, queue, params)
    summary.update(loop=label, wall_unprofiled_s=wall_plain, models_per_s_unprofiled=len(queue) / wall_plain)
    wall, bucket_iters, loop = summary["wall_s"], summary["bucket_iterations"], chip_smoke.loop_totals(rep)
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_engine_{label}.trace.json.gz"))
    print(f"[{label}] unprofiled wall {wall_plain:.4f}s ({len(queue) / wall_plain:.1f} models/s); "
          f"profiled wall {wall:.4f}s ({summary['models_per_s']:.1f} models/s), device busy "
          f"{summary['device_busy_ms']:.2f} ms = {summary['device_busy_share']:.3f} of wall, "
          f"{summary['kernels_launched']} device kernels, {summary['kernels_per_bucket_iteration']:.1f} per "
          f"bucket-iteration ({bucket_iters}); host-to-device copies {summary['h2d_ms']:.3f} ms; "
          f"{summary['replays_per_bucket_iteration']:.3f} replays and "
          f"{summary['stats_fetches_per_bucket_iteration']:.3f} stats fetches per bucket-iteration, "
          f"{loop['captures']} captures in {summary['capture_s']:.4f}s; host in launch calls "
          f"{summary['host_launch_ms']:.2f} ms, in synchronising calls {summary['host_sync_ms']:.2f} ms; "
          f"elementwise {summary['elementwise_ms']:.2f} ms in {summary['elementwise_launches']} launches; "
          f"normal inverse {summary['normal_inverse_ms']:.3f} ms", flush=True)
    for t in summary["top"]:
        print(f"  {t['ms']:9.3f} ms  {t['calls']:6d}  {t['name']}")
    return summary


def alternating_pairs(x, queue, params, n: int, threads=(1,)) -> dict:
    """Unprofiled walls of the graph loop and the per-iteration loop at
    each thread count in ``n`` rounds, each round every variant in turn
    (all warm): each variant's walls, median and range ("evict_t4", ...),
    and per round the wall ratios iter / graph at each thread count and
    threaded / serial (against the first count) of each loop, median and
    range."""
    from cp_cals_tpu_torch import cp_cals

    walls = {(mode, t): [] for t in threads for mode in ("evict", "iter")}
    for _ in range(n):
        for mode, t in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp_cals(x, queue, dataclasses.replace(params, sync_mode=mode, bucket_threads=t))
            torch.cuda.synchronize()
            walls[(mode, t)].append(time.perf_counter() - t0)

    def ratios(num, den) -> dict:
        r = sorted(a / b for a, b in zip(walls[num], walls[den]))
        return dict(median=r[n // 2], min=r[0], max=r[-1], all=r)

    out = {}
    for t in threads:
        out[f"ratio_iter_over_graph_t{t}"] = ratios(("iter", t), ("evict", t))
    for t in threads[1:]:
        for mode in ("evict", "iter"):
            out[f"ratio_t{t}_over_t{threads[0]}_{mode}"] = ratios((mode, t), (mode, threads[0]))
    for (mode, t), w in walls.items():
        s = sorted(w)
        out[f"{mode}_t{t}"] = dict(walls=w, median_s=s[n // 2], min_s=s[0], max_s=s[-1],
                                   models_per_s_median=len(queue) / s[n // 2])
        print(f"turns {mode} bucket_threads={t}: median wall {s[n // 2]:.4f}s "
              f"({len(queue) / s[n // 2]:.1f} models/s), range {s[0]:.4f}-{s[-1]:.4f}s over {n}", flush=True)
    for k, v in out.items():
        if k.startswith("ratio"):
            print(f"turns: wall {k} median {v['median']:.3f}, range {v['min']:.3f}-{v['max']:.3f}", flush=True)
    return out


def error_ops(x, queue, params) -> int:
    """PyTorch ops issued from ops/error.py in one run, host side only."""
    from torch.profiler import ProfilerActivity, profile

    from cp_cals_tpu_torch import cp_cals

    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        cp_cals(x, queue, params)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and any("ops/error.py" in f for f in (e.stack or ())))


def policies(x_np, repeats: int = 3) -> dict:
    """Walls of J1 at chunk lengths 1, 2, 4 and 8, and of J4 with the
    polish's done flags read every 4 sweeps or never: each variant after
    one warm-up, ``repeats`` times in turns with the others of its group,
    reported by the median wall."""
    from cp_cals_tpu_torch import jk_cp_cals
    from cp_cals_tpu_torch.solvers import graph_loop

    kt5, _ = chip_smoke.fit_jk_model(x_np)

    def run(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = jk_cp_cals(x_np, [kt5], params)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, rep

    def group(name, params, attr, values):
        default = getattr(graph_loop, attr)
        walls = {v: [] for v in values}
        reps = {}
        try:
            for v in values:  # warm-ups
                setattr(graph_loop, attr, v)
                run(params)
            for _ in range(repeats):
                for v in values:
                    setattr(graph_loop, attr, v)
                    wall, reps[v] = run(params)
                    walls[v].append(wall)
        finally:
            setattr(graph_loop, attr, default)
        out = {}
        for v in values:
            rep = reps[v]
            loop = chip_smoke.loop_totals(rep.cals_report)
            iters = [m.iters for m in rep.cals_report.models]
            wall = sorted(walls[v])[len(walls[v]) // 2]
            out[f"{name}_{attr.lower()}{v}"] = res = dict(
                wall_s=wall, walls=walls[v], replicates_per_s=len(iters) / wall,
                mean_iters=sum(iters) / len(iters),
                bucket_iterations=sum(rep.cals_report.engine_iterations.values()), **loop)
            print(f"policy {name} {attr}={v}: median wall {wall:.4f}s of {[round(w, 4) for w in walls[v]]}, "
                  f"{res['replicates_per_s']:.1f} replicates/s, mean iters {res['mean_iters']:.3f}, "
                  f"bucket-iterations {res['bucket_iterations']}, {loop['stats_fetches']} stats fetches, "
                  f"{loop['polish_sweeps']} polish sweeps", flush=True)
        return out

    out = group("J1", chip_smoke.jk_params(), "TOL_CHUNK", (1, 2, 4, 8))
    out.update(group("J4", chip_smoke.jk_params(**chip_smoke.J4), "POLISH_CHECK", (4, 25)))
    return out


def inverse_library() -> dict:
    """``torch.linalg.inv_ex`` (the inverses' yardstick, without the
    error check that synchronises) eager and replayed from a CUDA graph,
    at the bench-tier mix's (B, R) and J2's (320, 8), on SPD batches."""
    import numpy as np

    alloc = {4: 96, 8: 64, 12: 64, 16: 32, 20: 32, "J2": (320, 8)}
    out = {}
    rng = np.random.default_rng(0)
    for key, v in alloc.items():
        b, r = v if key == "J2" else (v, key)
        a = rng.normal(size=(b, r, r))
        h = torch.from_numpy((a @ a.transpose(0, 2, 1) + r * np.eye(r)).astype(np.float32)).cuda()
        try:
            g = chip_smoke.graph_ms(lambda: torch.linalg.inv_ex(h))
        except RuntimeError as e:  # a yardstick that cannot be captured is reported, not used
            g = None
            print(f"torch.linalg.inv_ex B={b} R={r} not captured: {str(e).splitlines()[0]}", flush=True)
        out[f"B{b}_R{r}"] = dict(ms=chip_smoke.cuda_ms(lambda: torch.linalg.inv(h)), graph_ms=g)
        print(f"torch.linalg.inv B={b} R={r}: {out[f'B{b}_R{r}']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiers", choices=sorted(TIERS), default="bench")
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--pairs", type=int, default=10, help="rounds of unprofiled runs of every variant in turn")
    ap.add_argument("--bucket-threads", default="1", help="comma list of bucket_threads counts, e.g. 1,4")
    args = ap.parse_args()
    threads = tuple(int(t) for t in args.bucket_threads.split(","))
    if not torch.cuda.is_available():
        print("profile_engine: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    x, rng = chip_smoke.bench_tensor()
    queue = chip_smoke.engine_queue(rng)
    params = chip_smoke.bench_params(**TIERS[args.tiers])
    summary = dict(card=card, tiers=args.tiers, bucket_threads=threads, loops={})
    for t in threads:
        for label, mode in (("graph", "evict"), ("iter", "iter")):
            summary["loops"][f"{label}_t{t}"] = trace(
                x, queue, dataclasses.replace(params, sync_mode=mode, bucket_threads=t), args.out,
                f"{args.tiers}_{label}_t{t}")
    summary["pairs"] = alternating_pairs(x, queue, params, args.pairs, threads)
    summary["error_py_ops"] = error_ops(x, queue, params)
    print(f"ops from ops/error.py (graph loop): {summary['error_py_ops']}", flush=True)
    summary["policies"] = policies(x)
    summary["inverse_library_graph_ms"] = inverse_library()
    with open(os.path.join(args.out, f"profile_engine_{args.tiers}.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "loops"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
