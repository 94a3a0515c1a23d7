"""One run of a cell: set-up, the measured window, the trace's reduction,
the correctness check and the result line.

A run makes its inputs from the seed, runs one untimed warm-up job (which
builds or loads the kernels, reads the lookup table and warms every shape
the cell's jobs use), then runs jobs back to back, one caller, closed loop,
until ``seconds`` have passed; the window ends with the last job, so every
job that started in it is counted whole. With ``trace`` the window runs
under the device profiler. After the window: the peak of allocated bytes
is read, the program's state is dropped, and the reference judges every
job's reported answers and the full answers of jobs sampled from the seed.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import arith, data
from . import trace as tracing
from .jobs import job_class
from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "cp_cals_tpu")  # whole top-level module names
SAMPLED_JOBS = 3  # jobs whose returned models the check compares in full
MARKER = "Memcpy HtoD"  # the copy that marks the window's start in the trace


@dataclass
class JobRecord:
    """What the window keeps of a job: its wall, the engine report's spans
    and counts, each model's (id, rank, iterations, fit) as arrays, and the
    fitted models themselves only for the sampled jobs."""

    start: float  # host clock, s
    wall_s: float
    n_models: int
    evict_s: float
    stats_fetches: int
    engine_iterations: int
    solver_s: float | None
    pre_s: float | None
    ids: np.ndarray
    ranks: np.ndarray
    iters: np.ndarray
    fits: np.ndarray
    results: object = None
    work: dict | None = None


@dataclass
class RunData:
    """What a metric reader (``metrics/<name>.py``) reads."""

    workload: str
    config: dict
    traffic: dict
    jobs: list
    window_s: float
    setup_s: float
    tiers: tuple  # (main MTTKRP tier, polish tier)
    peaks: dict | None
    trace: tracing.TraceData | None = None


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``cp_cals_tpu_torch`` is not ``cp_cals_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def card_readings() -> dict:
    """The card's name, power limit, SM clock and draw, from nvidia-smi
    (empty where there is none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit, sm, draw, temp = [s.strip() for s in out.splitlines()[0].split(",")]
    return dict(name=name, power_limit=limit, sm_clock=sm, power_draw=draw, temperature_c=temp)


def _reservoir(rng, kept: list, item, seen: int, k: int):
    """Keep ``k`` of the items seen so far, each with equal chance; returns
    the item that is not kept (this one or the one it replaces), or None."""
    if len(kept) < k:
        kept.append(item)
        return None
    j = int(rng.integers(0, seen))
    if j < k:
        kept[j], item = item, kept[j]
    return item


def record_of(out, t0: float, t1: float) -> JobRecord:
    rep = out.report
    models = rep.models
    return JobRecord(
        start=t0, wall_s=t1 - t0, n_models=out.n_models,
        evict_s=sum(pt.get("evict", 0.0) for pt in rep.phase_times.values()),
        stats_fetches=sum(c.get("stats_fetches", 0) for c in rep.loop_counts.values()),
        engine_iterations=sum(rep.engine_iterations.values()),
        solver_s=out.solver_s, pre_s=out.pre_s,
        ids=np.array([m.id for m in models]), ranks=np.array([m.rank for m in models]),
        iters=np.array([m.iters for m in models]), fits=np.array([m.fit for m in models]),
        results=out.results,
    )


def window(job, seconds: float, seed: int, profile: bool):
    """Jobs back to back until ``seconds`` have passed. Returns (records,
    every job's answers (the sampled jobs' in full), window seconds, host
    spans, the profiler or None, host time of the marker in us). Between
    jobs the harness keeps only a compact record, so its own objects add
    little to the interpreter's garbage collections."""
    rng = data.host_rng(seed, "sample")
    dev = job.device
    records, kept = [], []
    with tracing.profiled(profile, dev.type == "cuda") as prof:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        torch.ones(1).to(dev)  # the marker
        while True:
            t0 = time.perf_counter()
            out = job.run()
            t1 = time.perf_counter()
            records.append(record_of(out, t0, t1))
            dropped = _reservoir(rng, kept, len(records) - 1, len(records), SAMPLED_JOBS)
            if dropped is not None:
                records[dropped].results = None  # only the sampled jobs' models are kept
            if t1 - t_start >= seconds:
                break
        window_s = t1 - t_start
    answers = []
    for i, rec in enumerate(records):
        rec.work = job.work(rec)
        answers.append(job.answers(rec, full=i in kept))
        rec.results = None
    return records, answers, window_s, host_spans(records), prof, t_start * 1e6


def host_spans(records) -> list:
    """(what the host did, start us, end us) of every job: the engine call,
    and for the jackknife its set-up before and its rescale and LSAP after."""
    spans = []
    for r in records:
        t0, t1 = r.start, r.start + r.wall_s
        if r.pre_s is None:
            spans.append(("engine (cp_cals)", t0 * 1e6, t1 * 1e6))
        else:
            a, b = t0 + r.pre_s, t0 + r.pre_s + r.solver_s
            spans += [("jk_cp_cals set-up", t0 * 1e6, a * 1e6), ("engine (cp_cals)", a * 1e6, b * 1e6),
                      ("rescale and LSAP", b * 1e6, t1 * 1e6)]
    return spans


def judge(readings: dict, limits: dict) -> tuple[dict, bool]:
    """The compared numbers, each with its limit (``limits``' entries), and
    whether every one is within it."""
    checks = {name: dict(value=readings[name], limit=lim["limit"]) for name, lim in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run(workload: str, seed: int, seconds: float, trace: bool, device, chips: int = 1,
        registry: Registry | None = None, t_process: float | None = None, log=print) -> dict:
    """One run of ``workload``; returns the result line's object (and
    ``extra``, the earlier lines' numbers, apart)."""
    t0 = time.perf_counter() if t_process is None else t_process
    reg = registry or Registry()
    cell = reg.workload(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    dev = torch.device(device)
    from cp_cals_tpu_torch import _build
    from cp_cals_tpu_torch.utils import lut

    job = job_class(traffic["job"])(cfg, traffic, seed, dev)
    job.run()  # warm-up: kernels, lookups, every shape of the cell
    lut.reset_lookup_stats()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    card_before = card_readings()
    records, answers, window_s, spans, prof, marker_us = window(job, seconds, seed, trace)
    card_after = card_readings()
    lookups = dict(lut.LOOKUP_STATS)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    p = job.params
    tiers = (p.mttkrp_precision or p.precision, p.precision)
    run_data = RunData(workload=workload, config=cfg, traffic=traffic, jobs=records, window_s=window_s,
                       setup_s=setup_s, tiers=tiers, peaks=arith.PEAKS.get(kind))
    if prof is not None:
        t_read = time.perf_counter()
        run_data.trace = tracing.read(tracing.device_events(prof), window_s, reg.kernel_families(), spans,
                                      MARKER, marker_us)
        del prof
        log(f"trace read in {time.perf_counter() - t_read:.1f}s")
    # The program's state goes before the reference runs.
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = job.reference()
    readings = job.readings(answers, ref)
    ref_s = time.perf_counter() - t_ref
    checks, correct = judge(readings, limits)
    kind_of = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics_of(workload, kind_of):
        value = reg.metric(m["name"]).read(run_data)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    walls = [r.wall_s for r in records]
    extra = dict(
        workload=workload, seed=seed, trace=trace, card=card_before, card_after_window=card_after,
        build_s=_build.BUILD_SECONDS.get("wall", 0.0), lookup_stats=lookups, jobs=len(records),
        job_walls_s=walls, job_median_s=statistics.median(walls), setup_s=setup_s, window_s=window_s,
        memory_peak_bytes=peak, readings=readings, reference_s=ref_s,
        reference_sweeps=ref.get("sweeps") if isinstance(ref, dict) else None,
        base_fit=float(job.base_fit[0]) if hasattr(job, "base_fit") else None,
    )
    result = dict(
        correct=bool(correct), attempted=sum(r.n_models for r in records), failed=int(readings.get("bad", 0)),
        metrics=metrics,
        device=dict(platform="gpu" if dev.type == "cuda" else dev.type, kind=kind, count=chips,
                    memory_peak_bytes=int(peak)),
    )
    if run_data.trace is not None:
        t = run_data.trace
        extra["kernel_family_s"] = t.family_s
        extra["kernels_s"] = dict(sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:30])
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        top = sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = dict(device_ops=[[n[:120], s] for n, s in top],
                                   idle_gaps=[[n, s] for n, s in t.idle_gaps[:10]])
    result["checks"] = checks
    return dict(result=result, extra=extra)


def dumps(obj) -> str:
    return json.dumps(obj, default=float)
