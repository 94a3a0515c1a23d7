"""The program's spans and counters, the per-iteration trace and the CSV
reports (port of ``cp_cals_tpu/utils/timers.py``).

Spans and counters. ``span(name, tag)`` times a block and ``count(name,
n)`` counts; a ``Totals`` (one per call: a bucket's, a jackknife's) keeps
the same spans' and counters' totals for that call, and the reports are
filled from those totals (``CalsReport.phase_times`` and ``loop_counts``,
``JKReport.pre_time`` and ``solver_time``). Off, the default, a span costs
its pair of ``perf_counter_ns`` readings and keeps only the totals of the
``Totals`` it belongs to; no span, counter or interval is stored.

The recorder is on inside ``recording()`` (or between ``start()`` and
``stop()``) and while a ``torch.profiler`` session traces the process, so
a traced run carries the program's spans with no switch of its own. On,
every closed span is kept as a ``Span`` (name, tag, start and end, thread,
the innermost span open in its thread when it opened) and every counter
is summed, until the next recording begins or ``reset()``; ``spans()`` and
``counters()`` read them. Each thread keeps its own stack of open spans
(the engine's bucket threads run buckets at once). While on, every
interpreter garbage collection is a span ``gc`` tagged with its generation
and counts ``gc.collections``.

Clock: a span's start and end are nanoseconds on the profiler's clock,
the Unix epoch's (``time.time_ns``), onto which ``torch.profiler`` maps
its host and device events; the recorder reads ``perf_counter_ns`` and
adds the offset between the two clocks read when recording begins, so a
span and a kernel of the same trace compare directly.

Spans open per call, per bucket, per chunk, per polish, per eviction round,
per capture and per held layout built, never per model, kernel launch or
replay. The names, and
the metrics that read them, are listed in PERF.md §3.

A traced engine run takes one ``IterationRecord`` per engine iteration
(``RunTrace``, the upstream per-iteration CSV); FLOPs are analytic
(``ops/mttkrp.py``).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    tag: object  # the bucket's rank, a fetch's kind, a collection's generation, or None
    start_ns: int  # the profiler's clock (module docstring)
    end_ns: int
    thread: str
    parent: str | None  # the innermost span open in the thread when this one opened


_profiler_on = getattr(torch._C._autograd, "_profiler_enabled", lambda: False)
_perf_ns = time.perf_counter_ns
_LOCK = threading.RLock()  # reentrant: a collection can start while a counter is held
_local = threading.local()  # .stack: the thread's open spans' names; .gc_t0: its collection's start
_explicit = 0  # open recording() / start() calls
_open = False  # a recording is open
_OFF = object()  # a span opened while the recorder was off
_spans: list = []  # (name, tag, start, end on perf_counter_ns, thread, parent)
_counters: dict = {}
_offset_ns = 0  # the last recording's perf_counter_ns -> profiler clock offset


def _clock_offset() -> int:
    """time_ns() - perf_counter_ns(), from the tightest of a few bracketed
    readings."""
    best = None
    for _ in range(5):
        a = _perf_ns()
        t = time.time_ns()
        b = _perf_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _local.gc_t0 = _perf_ns() if (_explicit or _profiler_on()) else None
        return
    t0 = getattr(_local, "gc_t0", None)
    if t0 is None:
        return
    _local.gc_t0 = None
    stack = getattr(_local, "stack", None)
    _spans.append(("gc", info.get("generation"), t0, _perf_ns(), threading.current_thread().name,
                   stack[-1] if stack else None))
    _add("gc.collections", 1)


def _begin() -> None:
    """A new recording: the stores emptied, the clocks' offset read, the
    collection hook set (no-op if one is open)."""
    global _open, _offset_ns
    with _LOCK:
        if _open:
            return
        _spans.clear()
        _counters.clear()
        _offset_ns = _clock_offset()
        _open = True
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)


def _end() -> None:
    global _open
    with _LOCK:
        _open = False
        if _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)


def _sync() -> bool:
    """Whether the recorder is on now; opens a recording the profiler
    starts and closes one the profiler has ended."""
    on = bool(_explicit) or _profiler_on()
    if on and not _open:
        _begin()
    elif not on and _open:
        _end()
    return on


def _add(name: str, n) -> None:
    with _LOCK:
        _counters[name] = _counters.get(name, 0) + n


class _Span:
    __slots__ = ("name", "tag", "into", "t0", "parent")

    def __init__(self, name: str, tag, into):
        self.name, self.tag, self.into = name, tag, into

    def __enter__(self):
        if _explicit or _profiler_on():
            if not _open:
                _begin()
            stack = _local.__dict__.setdefault("stack", [])
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
        else:
            if _open:
                _end()
            self.parent = _OFF
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc):
        t1 = _perf_ns()
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0) + (t1 - self.t0)
        if self.parent is not _OFF:
            _local.stack.pop()
            _spans.append((self.name, self.tag, self.t0, t1, threading.current_thread().name, self.parent))
        return False


def span(name: str, tag=None) -> _Span:
    """A span of the block (recorded only while the recorder is on)."""
    return _Span(name, tag, None)


def count(name: str, n=1) -> None:
    """Adds ``n`` to the counter ``name`` while the recorder is on."""
    if _explicit or _profiler_on():
        _add(name, n)


class Totals(dict):
    """One call's totals, kept whether the recorder is on or off: each
    span's nanoseconds and each counter's sum, by name."""

    def span(self, name: str, tag=None) -> _Span:
        return _Span(name, tag, self)

    def count(self, name: str, n=1) -> None:
        self[name] = self.get(name, 0) + n
        if _explicit or _profiler_on():
            _add(name, n)

    def seconds(self, name: str) -> float:
        return self.get(name, 0) / 1e9


def start() -> None:
    """Switch the recorder on (a new recording, unless one is open)."""
    global _explicit
    with _LOCK:
        _explicit += 1
    _begin()


def stop() -> None:
    """Undo one ``start()``; what was recorded stays readable."""
    global _explicit
    with _LOCK:
        _explicit = max(_explicit - 1, 0)
    _sync()


def reset() -> None:
    """Drop what has been recorded (the recorder stays as it is)."""
    with _LOCK:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def recording():
    """The recorder on for the block."""
    start()
    try:
        yield
    finally:
        stop()


def is_recording() -> bool:
    return _sync()


def spans() -> list[Span]:
    """The spans of the last (or open) recording, in the order they
    closed, on the profiler's clock."""
    _sync()
    off = _offset_ns
    return [Span(n, tag, s + off, e + off, th, p) for n, tag, s, e, th, p in list(_spans)]


def counters() -> dict:
    """The counters of the last (or open) recording."""
    _sync()
    with _LOCK:
        return dict(_counters)


@dataclass
class IterationRecord:
    iteration: int
    active_models: int
    active_columns: int
    flops: int
    wall_s: float
    bucket: int = 0  # the bucket rank the record belongs to


@dataclass
class RunTrace:
    """Per-iteration trace: live models, live true-rank columns, FLOPs at
    those columns, and wall time, per engine iteration of each bucket."""

    records: list = field(default_factory=list)

    def add(self, rec: IterationRecord) -> None:
        self.records.append(rec)

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, delimiter=";")
            w.writerow(["ITER", "MODELS", "COLS", "FLOPS", "TIME", "BUCKET"])
            for r in self.records:
                w.writerow(
                    [r.iteration, r.active_models, r.active_columns, r.flops,
                     f"{r.wall_s:.9f}", r.bucket]
                )

    @property
    def total_time(self) -> float:
        return sum(r.wall_s for r in self.records)

    @property
    def total_flops(self) -> int:
        return sum(r.flops for r in self.records)


def write_cals_report_csv(path: str, report, params=None) -> None:
    """The run report with its configuration: a commented header of the
    solver parameters and the report's totals, then one row per model."""
    with open(path, "w", newline="") as f:
        if params is not None:
            for field_ in dataclasses.fields(params):
                v = getattr(params, field_.name)
                v = getattr(v, "value", v)
                f.write(f"# {field_.name}={v}\n")
        f.write(f"# n_ktensors={report.n_ktensors}\n")
        f.write(f"# ktensor_comp_sum={report.ktensor_comp_sum}\n")
        for r, pt in getattr(report, "phase_times", {}).items():
            pretty = ",".join(f"{k}={v:.4f}" for k, v in pt.items())
            f.write(f"# bucket_{r}_times={pretty}\n")
        w = csv.writer(f, delimiter=";")
        w.writerow(["KTENSOR_ID", "RANK", "ERROR", "FIT", "ITERS"])
        for m in report.models:
            w.writerow(
                [m.id, m.rank, f"{m.approx_error:.17g}", f"{m.fit:.17g}",
                 m.iters]
            )


def write_ktensor_results_csv(path: str, model_reports) -> None:
    """id;rank;error;iters per model."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["KTENSOR_ID", "RANK", "ERROR", "ITERS"])
        for m in model_reports:
            w.writerow([m.id, m.rank, f"{m.approx_error:.17g}", m.iters])
