"""The program's spans in the benchmark: the idle gaps named by them
(synthetic events, with the fallback to the harness's name), the readers
of the metrics they give in a tiny traced run, and each reader's None
where the program recorded nothing or has no recorder."""

from types import SimpleNamespace

import pytest

from cals_bench import program_spans, runner
from cp_cals_tpu_torch.utils import timers
from cp_cals_tpu_torch.utils.timers import Span

NEW = ("fetch_wait_pct", "capture_pct", "gc_pause_pct", "jk_precompile_pct")


def span(name, a_us, b_us, tag=None, parent=None):
    return Span(name, tag, int(a_us * 1e3), int(b_us * 1e3), "MainThread", parent)


def test_gaps_named_by_the_innermost_program_span():
    """Three kernels, two gaps: the first mostly under evict.round (inside
    engine.bucket), the second under no program span, so it keeps the
    harness's name; the idle seconds go to the innermost span at each
    instant."""
    events = [("k1", 0.0, 10.0), ("k2", 100.0, 110.0), ("k3", 300.0, 310.0)]
    host = [("engine (cp_cals)", 0.0, 400.0)]
    program = [span("evict.round", 20, 90, parent="engine.bucket"), span("engine.bucket", 5, 105, tag=4)]
    data, idle = program_spans.name_gaps(events, 1.0, {}, host, None, 0.0, program)
    assert data.idle_gaps == [("engine (cp_cals) | before k3", pytest.approx(190e-6)),
                              ("engine (cp_cals) > evict.round | before k2", pytest.approx(90e-6))]
    assert idle == pytest.approx({"evict.round": 70e-6, "engine.bucket[4]": 20e-6, "none": 190e-6})
    plain, none = program_spans.name_gaps(events, 1.0, {}, host, None, 0.0, ())
    assert [n for n, _ in plain.idle_gaps] == ["engine (cp_cals) | before k3", "engine (cp_cals) | before k2"]
    assert none == {}


def test_innermost_pieces_of_nested_spans():
    program = [span("a", 0, 100), span("b", 10, 40, parent="a"), span("c", 20, 30, parent="b"),
               span("d", 60, 70, parent="a")]
    assert program_spans.innermost(program) == [(0, 10, "a"), (10, 20, "b"), (20, 30, "c"), (30, 40, "b"),
                                                (40, 60, "a"), (60, 70, "d"), (70, 100, "a")]


def test_traced_run_reports_the_program_span_metrics(tiny):
    out = runner.run("tiny.jk", 2**32 + 5, 0.3, True, "cpu", registry=tiny, log=lambda m: None)
    metrics = out["result"]["metrics"]
    assert {"fetch_wait_pct", "jk_precompile_pct"} <= set(metrics)
    assert "capture_pct" not in metrics  # no card: nothing is captured
    for name in ("fetch_wait_pct", "jk_precompile_pct"):
        assert 0 < metrics[name]["value"] < 100 and metrics[name]["unit"] == "%"
    if "gc_pause_pct" in metrics:  # only where a collection fell in the window
        assert 0 < metrics["gc_pause_pct"]["value"] < 100


def test_readers_are_none_without_the_programs_spans(tiny, monkeypatch):
    run = SimpleNamespace(jobs=[SimpleNamespace(wall_s=1.0)], window_s=1.0)
    timers.reset()
    assert all(tiny.metric(n).read(run) is None for n in NEW)
    with timers.recording():
        with timers.span("loop.fetch", "chunk"):
            pass
    assert tiny.metric("fetch_wait_pct").read(run) > 0
    assert tiny.metric("jk_precompile_pct").read(run) is None and tiny.metric("gc_pause_pct").read(run) is None
    monkeypatch.delattr(timers, "spans")  # a program without its recorder
    assert all(tiny.metric(n).read(run) is None for n in NEW)
