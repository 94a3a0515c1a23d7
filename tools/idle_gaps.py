"""Where the card's idle time goes in a benchmark cell, by the program's
own spans.

    python3 tools/idle_gaps.py --workload fluor.jk299 --seed 7 --seconds 30 [--out chiprun_out/idle_gaps]

Runs the cell as ``cals_bench/run.py --trace 1`` does (inputs from the
seed, one warm-up job, then jobs back to back under the device profiler,
``cals_bench/runner.window``), with the program's recorder on for the
window (it follows the profiler), and reduces the trace with the
program's spans (``cals_bench/program_spans.name_gaps``): the idle
seconds under each innermost program span, per job; the share of the
idle time under a span finer than the job-level ``jk.engine`` and
``engine.bucket``; the ten longest gaps, named; each span's seconds and
each counter per job; the stats fetches split by kind per engine
iteration. First it checks the clock: a kernel launched and waited for
inside a span lies inside that span on the profiler's clock. Writes
``<out>/<workload>.<seed>.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["CP_CALS_NO_AUTOTUNE"] = "1"

COARSE = ("jk.engine", "engine.bucket", "none")  # labels that name no finer phase


def clock_check(dev) -> dict:
    """A spin kernel launched and waited for inside a span, 5 ms of host
    sleep on either side, under the harness's profiler: how far inside the
    span its device interval lies (about 5 ms at each end when the clocks
    agree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cals_bench import trace as tracing
    from cp_cals_tpu_torch.utils import timers

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timers.span("clock.check"):
            time.sleep(0.005)
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(dev)
            time.sleep(0.005)
    sp = next(s for s in timers.spans() if s.name == "clock.check")
    ev = [e for e in tracing.device_events(prof) if "spin" in e[0]]
    if len(ev) != 1:
        return dict(ok=False, reason="no spin kernel event")
    _, s_us, e_us = ev[0]
    lead, lag = s_us - sp.start_ns / 1e3, sp.end_ns / 1e3 - e_us
    return dict(ok=lead > 2000 and lag > 2000, kernel_after_span_start_us=lead, span_end_after_kernel_us=lag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "idle_gaps"))
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from cals_bench import program_spans, runner
    from cals_bench import trace as tracing
    from cals_bench.jobs import job_class
    from cals_bench.registry import Registry
    from cp_cals_tpu_torch.utils import timers

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    job = job_class(traffic["job"])(cfg, traffic, args.seed, dev)
    job.run()
    torch.cuda.synchronize(dev)
    check = clock_check(dev)
    records, _, window_s, host_spans, prof, marker_us = runner.window(job, args.seconds, args.seed, True)
    program, counters = timers.spans(), timers.counters()
    t_read = time.perf_counter()
    data, idle = program_spans.name_gaps(tracing.device_events(prof), window_s, reg.kernel_families(), host_spans,
                                         runner.MARKER, marker_us, program)
    del prof
    n = len(records)
    walls = [r.wall_s for r in records]
    iters = sum(r.engine_iterations for r in records)
    idle_s = sum(idle.values())
    finer = sum(v for k, v in idle.items() if k.split("[")[0] not in COARSE)
    by_name: collections.Counter = collections.Counter()
    for s in program:
        by_name[s.name] += (s.end_ns - s.start_ns) / 1e9
    out = dict(
        workload=args.workload, seed=args.seed, card=runner.card_readings(), clock=check, jobs=n,
        window_s=window_s, models_per_s=sum(r.n_models for r in records) / window_s,
        job_median_s=statistics.median(walls), busy_s=data.busy_s, idle_in_gaps_s=idle_s,
        idle_under_finer_span_pct=100.0 * finer / idle_s if idle_s else None,
        idle_s_per_job={k: v / n for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        idle_gaps=data.idle_gaps,
        span_s_per_job={k: v / n for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])},
        span_pct_of_wall={k: 100.0 * v / sum(walls) for k, v in by_name.items()},
        counters_per_job={k: v / n for k, v in sorted(counters.items())},
        per_engine_iteration={k: counters.get(k, 0) / iters for k in
                              ("fetches.chunk", "fetches.polish", "fetches.evict")} if iters else {},
        engine_iterations_per_job=iters / n, reduce_s=time.perf_counter() - t_read,
    )
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.workload}.{args.seed}.json").write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({k: out[k] for k in ("workload", "clock", "jobs", "models_per_s", "busy_s", "idle_in_gaps_s",
                                          "idle_under_finer_span_pct", "per_engine_iteration")}, default=float))
    for name, s in data.idle_gaps:
        print(f"  gap {s:.4f}s {name}")
    for k, v in list(out["idle_s_per_job"].items())[:12]:
        print(f"  idle {v * 1e3:8.3f} ms/job under {k}")
    return 0 if check["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
