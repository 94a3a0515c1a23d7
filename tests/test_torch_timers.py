"""The program's span-and-counter recorder (``cp_cals_tpu_torch/utils/
timers.py``) on the CPU: nesting and parents, each thread's own stack, the
off mode (totals kept, nothing recorded), the interpreter's collections,
the profiler's clock, the recorder following a profiler session; and the
engine's spans in a tiny jackknife: every listed name, the reports filled
from them (``phase_times``, ``loop_counts``, ``pre_time`` and
``solver_time``), a capture's span, and results the same recorded or
not."""

import gc
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cp_cals_tpu_torch import CalsParams, RandomKtensorSpec, cp_cals, random_ktensor_host
from cp_cals_tpu_torch.solvers import graph_loop
from cp_cals_tpu_torch.solvers.jackknife import jk_cp_cals
from cp_cals_tpu_torch.utils import timers

MODES = (12, 11, 10)
# The spans a jackknife run on the CPU opens (loop.capture opens on the card
# only: test_capture_span_and_counts).
JK_SPANS = {"jk.prepare", "jk.precompile", "jk.engine", "jk.rescale", "jk.lsap", "engine.norms",
            "engine.programs", "engine.bucket", "engine.results", "bucket.intake", "bucket.solve", "loop.chunk",
            "loop.fetch", "loop.polish", "evict.round", "evict.store", "evict.refill", "evict.kill",
            "evict.compact", "bucket.checkpoint"}


@pytest.fixture(autouse=True)
def _fresh():
    timers.reset()
    yield
    assert not timers.is_recording()


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_nest_with_parents_and_tags():
    with timers.recording():
        with timers.span("a", 1):
            with timers.span("b"):
                timers.count("n", 3)
            with timers.span("c", "x"):
                timers.count("n")
    a, = by_name(timers.spans(), "a")
    b, = by_name(timers.spans(), "b")
    c, = by_name(timers.spans(), "c")
    assert (a.parent, b.parent, c.parent) == (None, "a", "a")
    assert (a.tag, b.tag, c.tag) == (1, None, "x")
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns <= a.end_ns
    assert [s.name for s in timers.spans()] == ["b", "c", "a"]  # in the order they closed
    assert timers.counters() == {"n": 4} and a.thread == threading.current_thread().name


def test_each_thread_keeps_its_own_stack():
    """Two threads with spans open at once: each span's parent is its own
    thread's, never the other's."""
    go = threading.Barrier(2)

    def work(name):
        with timers.span(f"{name}.outer"):
            go.wait()
            with timers.span(f"{name}.inner"):
                go.wait()

    with timers.recording():
        ts = [threading.Thread(target=work, args=(n,), name=n) for n in ("t0", "t1")]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    for n in ("t0", "t1"):
        inner, = by_name(timers.spans(), f"{n}.inner")
        outer, = by_name(timers.spans(), f"{n}.outer")
        assert (inner.parent, inner.thread, outer.parent, outer.thread) == (f"{n}.outer", n, None, n)


def test_counters_and_spans_lose_nothing_under_thread_switches():
    """More threads than cores counting and opening spans at once, with
    the interpreter switching threads as often as it can: every count and
    span kept."""
    import os
    import sys

    n_threads, n = 2 * (os.cpu_count() or 2) + 2, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timers.recording():
            def work():
                for _ in range(n):
                    with timers.span("s"):
                        timers.count("c")

            ts = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert timers.counters()["c"] == n_threads * n
    assert len(by_name(timers.spans(), "s")) == n_threads * n


def test_bucket_threads_spans_in_their_threads():
    """bucket_threads=2, two buckets: each bucket's spans lie in the thread
    of its engine.bucket span and inside it, and a bucket thread's stack
    starts empty."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(MODES)
    queue = [random_ktensor_host(rng, MODES, r, dtype=np.float64) for r in (1, 2, 3, 4, 1, 3)]
    with timers.recording():
        cp_cals(x, queue, CalsParams(tol=1e-6, max_iterations=20, bucket_ranks=(2, 4), buffer_size=12,
                                     bucket_threads=2), device="cpu")
    sp = timers.spans()
    buckets = by_name(sp, "engine.bucket")
    assert sorted(b.tag for b in buckets) == [2, 4]
    assert len({b.thread for b in buckets}) == 2 and all(b.parent is None for b in buckets)
    for s in sp:
        if s.name.startswith(("bucket.", "evict.", "loop.")):
            b, = [b for b in buckets if b.thread == s.thread]
            assert b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns
            assert s.parent is not None


def test_off_records_nothing_and_keeps_totals():
    tot = timers.Totals()
    with tot.span("a"):
        with tot.span("b"):
            pass
    tot.count("n", 2)
    timers.count("m")
    with timers.span("c"):
        gc.collect()
    assert not timers.is_recording()
    assert timers.spans() == [] and timers.counters() == {}
    assert tot["n"] == 2 and tot["a"] >= tot["b"] > 0 and tot.seconds("a") == tot["a"] / 1e9
    assert timers._on_gc not in gc.callbacks


def test_collections_are_spans_while_on():
    with timers.recording():
        assert timers._on_gc in gc.callbacks
        with timers.span("outer"):
            gc.collect()
    assert timers._on_gc not in gc.callbacks
    g = [s for s in by_name(timers.spans(), "gc") if s.tag == 2]
    assert g and g[0].parent == "outer" and timers.counters()["gc.collections"] >= 1
    outer, = by_name(timers.spans(), "outer")
    assert outer.start_ns <= g[0].start_ns <= g[0].end_ns <= outer.end_ns


def test_spans_on_the_profilers_clock():
    """A span around a record_function block, under a CPU-activity
    profiler: the profiler's event lies inside the span, within 1 ms at
    either end."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.span("outer"):
            with record_function("inner"):
                torch.ones(64).sum()
    outer, = by_name(timers.spans(), "outer")
    ev, = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert outer.start_ns <= start <= end <= outer.end_ns
    assert start - outer.start_ns < 1_000_000 and outer.end_ns - end < 1_000_000


def test_the_recorder_follows_a_profiler_session():
    """While a profiler runs the recorder records (a new recording each
    session); after it, nothing more, and what it recorded stays readable."""
    with timers.span("before"):
        pass
    for i in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            assert timers.is_recording()
            with timers.span(f"in{i}"):
                timers.count("n")
        with timers.span("after"):
            pass
        assert [s.name for s in timers.spans()] == [f"in{i}"] and timers.counters() == {"n": 1}
        assert not timers.is_recording() and timers._on_gc not in gc.callbacks


def jk_problem(seed=5):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 0.05 * rng.standard_normal(MODES)
    # 12 replicates through 6 slots: refills, kills and a tail compaction.
    params = CalsParams(tol=1e-6, max_iterations=60, buffer_size=24, bucket_ranks=(4,), tol_check_interval=5,
                        polish_iters=25, polish_tol=1e-6, evict_batch=2)
    return x, kt, params


def test_jackknife_spans_fill_the_reports(tmp_path):
    x, kt, params = jk_problem()
    with timers.recording():
        rep = jk_cp_cals(x, [kt], params, device="cpu", checkpoint_dir=str(tmp_path))
    sp, counts = timers.spans(), timers.counters()
    assert JK_SPANS <= {s.name for s in sp}
    assert not by_name(sp, "loop.capture") and "captures" not in counts  # nothing is captured on the CPU
    cr = rep.cals_report
    (r, pt), = cr.phase_times.items()
    ns = {n: sum(s.end_ns - s.start_ns for s in by_name(sp, n)) for n in
          ("evict.round", "bucket.intake", "bucket.checkpoint", "bucket.solve", "jk.prepare", "jk.precompile",
           "jk.engine")}
    assert pt["evict"] == ns["evict.round"] / 1e9 and pt["setup"] == ns["bucket.intake"] / 1e9
    assert pt["solve"] == ns["bucket.solve"] / 1e9 and pt["checkpoint"] == ns["bucket.checkpoint"] / 1e9
    assert rep.pre_time == ns["jk.prepare"] / 1e9 + ns["jk.precompile"] / 1e9
    assert rep.solver_time == ns["jk.engine"] / 1e9
    lc = cr.loop_counts[r]
    assert lc["stats_fetches"] == counts["fetches.chunk"] + counts["fetches.polish"] + counts["fetches.evict"]
    assert counts["fetches.evict"] == lc["checkpoints"] == len(by_name(sp, "evict.store")) > 1
    assert counts["fetches.polish"] > 0 and lc["polish_sweeps"] == counts["polish_sweeps"]
    kinds = [s.tag for s in by_name(sp, "loop.fetch")]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "chunk": counts["fetches.chunk"], "polish": counts["fetches.polish"], "evict": counts["fetches.evict"]}
    assert counts["uploads"] > 0 and counts["upload_bytes"] > 0 and counts["fetch_bytes"] > 0
    assert by_name(sp, "engine.bucket")[0].tag == 4
    for name, parent in (("evict.refill", "evict.round"), ("loop.chunk", "bucket.solve"),
                         ("bucket.solve", "engine.bucket"), ("engine.bucket", "jk.engine"),
                         ("engine.norms", "jk.engine"), ("loop.polish", "bucket.solve")):
        assert {s.parent for s in by_name(sp, name)} == {parent}, name


# The (span, parent) pairs of a small engine run with a checkpoint dir, on
# the CPU; the "evict" loop adds the polish. The per-layer metrics and the
# gap naming read spans by these names and parents.
ENGINE_PAIRS = {
    ("engine.norms", None), ("engine.programs", None), ("layouts.build", "engine.programs"),
    ("engine.bucket", None), ("engine.results", None), ("bucket.intake", "engine.bucket"),
    ("bucket.solve", "engine.bucket"), ("loop.chunk", "bucket.solve"), ("loop.fetch", "bucket.solve"),
    ("evict.round", "engine.bucket"), ("evict.store", "evict.round"), ("loop.fetch", "evict.store"),
    ("evict.refill", "evict.round"), ("evict.kill", "evict.round"), ("evict.compact", "evict.round"),
    ("bucket.checkpoint", "engine.bucket"),
}
ENGINE_COUNTERS = {"checkpoints", "fetch_bytes", "fetches.chunk", "fetches.evict", "layouts.held_bytes",
                   "upload_bytes", "uploads"}


@pytest.mark.parametrize("sync_mode", ["evict", "iter"])
def test_engine_spans_and_report_keys(sync_mode, tmp_path):
    """A traced run of ten models (one a spec) through four slots, with
    refills, kills, a tail compaction and a checkpoint after every round:
    exactly these (span, parent) pairs and counters, and these
    ``phase_times`` and ``loop_counts`` keys."""
    rng = np.random.default_rng(7)
    kt = random_ktensor_host(rng, MODES, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 0.05 * rng.standard_normal(MODES)
    queue = [random_ktensor_host(rng, MODES, r, dtype=np.float64) for r in (1, 2, 3, 4, 2, 3, 1, 4, 3)]
    queue.append(RandomKtensorSpec(MODES, 2, seed=3, dtype="float64"))
    params = CalsParams(tol=1e-6, max_iterations=60, buffer_size=16, bucket_ranks=(4,), polish_iters=3,
                        sync_mode=sync_mode)
    trace = timers.RunTrace()
    with timers.recording():
        res, rep = cp_cals(x, queue, params, device="cpu", checkpoint_dir=str(tmp_path), trace=trace)
    sp, counts = timers.spans(), timers.counters()
    polish = {("loop.polish", "bucket.solve")} if sync_mode == "evict" else set()
    assert {(s.name, s.parent) for s in sp if s.name != "gc"} == ENGINE_PAIRS | polish
    assert set(counts) - {"gc.collections"} == ENGINE_COUNTERS | ({"polish_sweeps"} if polish else set())
    assert all(r is not None for r in res) and sorted(m.id for m in rep.models) == list(range(10))
    (r, pt), = rep.phase_times.items()
    assert r == 4 and set(pt) == {"setup", "solve", "evict", "capture", "checkpoint"}
    assert set(rep.loop_counts[4]) == {"captures", "graph_reuses", "replays", "stats_fetches", "polish_sweeps",
                                       "checkpoints", "spec_builds"}
    assert rep.loop_counts[4]["spec_builds"] > 0 and rep.loop_counts[4]["checkpoints"] > 1
    assert [t.iteration for t in trace.records] == list(range(1, rep.engine_iterations[4] + 1))


def test_recording_moves_no_result():
    """The same jackknife recorded and not: bit for bit, the same counts."""
    x, kt, params = jk_problem(6)
    plain = jk_cp_cals(x, [kt], params, device="cpu")
    with timers.recording():
        rec = jk_cp_cals(x, [kt], params, device="cpu")
    assert plain.cals_report.loop_counts == rec.cals_report.loop_counts
    for a, b in zip(plain.results[0], rec.results[0]):
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


def test_capture_span_and_counts():
    """A chunk's first call with graphs: loop.capture holds the eager call
    and the capture, inside the loop.chunk span; one capture, and n - 1
    replays in the first chunk and n in the next, counted in the loop's
    totals and the recorder's."""
    calls = []

    class Graph:
        def replay(self, n):
            calls.extend(["replay"] * n)

    class Graphs:
        def capture(self, fn):
            calls.append("capture")
            return Graph()

    class Loop:
        _run = graph_loop.ChunkLoop._run

    loop = Loop()
    loop.graphs, loop.totals, loop.buf = Graphs(), timers.Totals(), SimpleNamespace(step_graph=None)
    with timers.recording():
        for n in (3, 2):
            with loop.totals.span("loop.chunk"):
                loop._run(lambda: calls.append("eager"), "step_graph", n)
    assert calls == ["eager", "capture", "replay", "replay", "replay", "replay"]
    cap, = by_name(timers.spans(), "loop.capture")
    first = by_name(timers.spans(), "loop.chunk")[0]
    assert cap.parent == "loop.chunk" and first.start_ns <= cap.start_ns <= cap.end_ns <= first.end_ns
    assert loop.totals["captures"] == 1 and loop.totals["replays"] == 4 and loop.totals["loop.capture"] > 0
    assert timers.counters() == {"captures": 1, "replays": 4}
