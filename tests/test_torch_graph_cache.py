"""The CUDA graphs that engine calls keep (``solvers/cals.py:GraphCache``,
``solvers/graph_loop.py:Graphs``), on the CPU, with a stub in place of
``graph_loop.Graph`` and a graph cache lent to the CPU.

The stub keeps the function it was given and runs it at each replay, as a
graph re-runs its captured kernels on the pointers they were captured
with: a replay in a later call runs the capturing loop's bound step, on
the buffers, X, |X| and layouts that loop held. So a call that takes a
kept graph gives a fresh capture's bits only where the engine wrote the
call's values into exactly those buffers.

- The same key hits: a second call is bit for bit the call after a
  release, with no capture and every graph reused (model selection with
  refills, a tol-driven jackknife with polish and tail compaction, four
  bucket threads), and a new X of the same shape or an X written in place
  between calls gives the results of a call after a release.
- A changed param, shape, dtype or traced flag misses, and releases every
  kept entry before the call allocates; a changed batch misses at its loop
  alone; ``release_graphs`` empties the cache; a compacted loop takes the
  half-batch entry.
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from cp_cals_tpu_torch import CalsParams, random_ktensor_host, release_graphs
from cp_cals_tpu_torch.solvers import cals, graph_loop
from cp_cals_tpu_torch.solvers.jackknife import jk_cp_cals
from cp_cals_tpu_torch.utils import timers

MODES = (9, 8, 7)
SELECT = CalsParams(max_iterations=8, force_max_iter=True, bucket_ranks=(2, 4), buffer_size=20,
                    tail_compaction_depth=0)  # batches 4 and 2 of the rank-2 and rank-4 buckets
JK = CalsParams(tol=1e-6, max_iterations=40, bucket_ranks=(4,), buffer_size=40, tol_check_interval=5,
                polish_iters=6, polish_tol=1e-9, evict_batch=2, tail_compaction_depth=2)


class StubGraph:
    """A captured ``fn``, run again at each replay."""

    made = 0

    def __init__(self, fn, pool=None):
        self.fn = fn
        StubGraph.made += 1

    def replay(self, n):
        for _ in range(n):
            self.fn()


@pytest.fixture
def cache(monkeypatch):
    """A graph cache for the CPU: the engine's streams are Nones, and
    ``release_graphs`` finds the cache as it finds a card's."""
    kept = cals.GraphCache()

    @contextlib.contextmanager
    def streams(dev, n):
        with busy:
            yield [None] * n, kept

    busy = threading.Lock()
    monkeypatch.setattr(cals, "_bucket_streams", streams)
    monkeypatch.setitem(cals._STREAMS, "cpu", ([], busy, kept))
    monkeypatch.setattr(graph_loop, "Graph", StubGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    return kept


def problem(seed=0, ranks=(1, 2, 3, 4, 2, 3, 1, 4, 2), dtype=np.float32):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 2, dtype=dtype)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 1e-2 * rng.standard_normal(MODES)).astype(dtype)
    return x, [random_ktensor_host(rng, MODES, r, dtype=dtype) for r in ranks], kt


def run(x, queue, params, **kw):
    return cals.cp_cals(x, queue, params, device="cpu", **kw)


def jk_run(x, kt, params):
    rep = jk_cp_cals(x, [kt], params, device="cpu")
    return rep.results[0], rep.cals_report


def totals(rep) -> dict:
    return {k: sum(c[k] for c in rep.loop_counts.values()) for k in ("captures", "graph_reuses", "replays")}


def assert_same(a, b):
    (res_a, rep_a), (res_b, rep_b) = a, b
    assert [(m.id, m.iters, m.fit, m.approx_error) for m in rep_a.models] == \
        [(m.id, m.iters, m.fit, m.approx_error) for m in rep_b.models]
    assert rep_a.engine_iterations == rep_b.engine_iterations
    for ka, kb in zip(res_a, res_b):
        for fa, fb in zip(ka.factors + (ka.lam,), kb.factors + (kb.lam,)):
            np.testing.assert_array_equal(fa, fb)


def loop_keys(kept) -> set:
    return {key for g in kept.slots for key in g.loops}


def kept_buffers(kept) -> list:
    return [buf for g in kept.slots for buf in g.loops.values()]


@pytest.mark.parametrize("case", ["select", "jackknife", "threads"])
def test_a_second_call_replays_what_the_first_captured(cache, case):
    x, queue, kt = problem()
    if case == "jackknife":
        call = lambda: jk_run(x, kt, JK)  # noqa: E731
    else:
        params = dataclasses.replace(SELECT, bucket_threads=4) if case == "threads" else SELECT
        call = lambda: run(x, queue, params)  # noqa: E731
    release_graphs()
    first = call()
    assert totals(first[1])["captures"] > 0 and totals(first[1])["graph_reuses"] == 0
    made = StubGraph.made
    second = call()
    assert_same(first, second)
    if case != "threads":  # threads may take another stream slot than last time, and capture there
        assert StubGraph.made == made
        assert totals(second[1]) == dict(captures=0, graph_reuses=totals(first[1])["captures"],
                                         replays=totals(first[1])["replays"] + totals(first[1])["captures"])
    assert totals(second[1])["graph_reuses"] > 0


def test_a_new_x_or_one_written_in_place_gives_a_fresh_calls_results(cache):
    x, queue, _ = problem()
    xt = torch.from_numpy(x.copy())
    run(xt, queue, SELECT)
    other = problem(seed=1)[0]
    got = run(torch.from_numpy(other), queue, SELECT)
    assert totals(got[1])["captures"] == 0
    release_graphs()
    assert_same(got, run(torch.from_numpy(other), queue, SELECT))
    run(xt, queue, SELECT)
    xt.mul_(0.5)  # the caller's own tensor, which the kept copy must not alias
    got = run(xt, queue, SELECT)
    assert totals(got[1])["captures"] == 0
    release_graphs()
    assert_same(got, run(xt, queue, SELECT))


@pytest.mark.parametrize("change", ["param", "shape", "dtype", "traced"])
def test_a_changed_call_key_releases_every_entry_before_it_allocates(cache, monkeypatch, change):
    x, queue, _ = problem()
    release_graphs()
    run(x, queue, SELECT)
    before, kept_x = kept_buffers(cache), cache.x
    kw = {}
    params = SELECT
    if change == "param":
        params = dataclasses.replace(SELECT, max_iterations=9)
    elif change == "shape":
        x, queue, _ = problem(ranks=(1, 2, 3, 4, 2, 3, 1, 4, 2))
        x = np.concatenate([x, x[:1]])
        queue = [k._replace(factors=(np.concatenate([k.factors[0], k.factors[0][:1]]),) + k.factors[1:])
                 for k in queue]
    elif change == "dtype":
        x, queue, _ = problem(dtype=np.float64)
    else:
        kw["trace"] = timers.RunTrace()
    order = []
    release = cache.release
    monkeypatch.setattr(cache, "release", lambda: (order.append("release"), release()))
    norms = cals._norms
    monkeypatch.setattr(cals, "_norms", lambda *a: (order.append("norms"), norms(*a))[1])
    _, rep = run(x, queue, params, **kw)
    assert order[:2] == ["release", "norms"] and order.count("release") == 1
    assert totals(rep)["captures"] > 0 and totals(rep)["graph_reuses"] == 0
    assert cache.x is not kept_x and not {id(b) for b in before} & {id(b) for b in kept_buffers(cache)}
    assert len(kept_buffers(cache)) == len(rep.loop_counts)


def test_a_changed_batch_misses_at_its_loop_alone(cache):
    x, queue, _ = problem()
    release_graphs()
    run(x, queue, SELECT)
    kept_x, before = cache.x, loop_keys(cache)
    _, rep = run(x, queue[:4], SELECT)  # the rank-2 bucket's batch halves, the rank-4 one's stays
    assert cache.x is kept_x
    new, = loop_keys(cache) - before
    assert new[0] == (2, 2) and {k[0] for k in before} == {(4, 2), (2, 4)}
    assert rep.loop_counts[2]["captures"] == 1 and rep.loop_counts[2]["graph_reuses"] == 0
    assert rep.loop_counts[4]["captures"] == 0 and rep.loop_counts[4]["graph_reuses"] == 1


def test_release_graphs_empties_the_cache(cache):
    x, queue, _ = problem()
    run(x, queue, SELECT)
    assert cache.key is not None and cache.slots and cache.layouts is not None
    release_graphs()
    assert (cache.key, cache.x, cache.x_norm, cache.layouts, cache.slots) == (None, None, None, {}, [])
    _, rep = run(x, queue, SELECT)
    assert totals(rep)["captures"] > 0 and totals(rep)["graph_reuses"] == 0


def test_a_compacted_loop_takes_the_half_batch_entry(cache):
    x, _, kt = problem()
    release_graphs()
    _, rep = jk_run(x, kt, JK)
    batches = sorted({key[0][0] for key in loop_keys(cache)}, reverse=True)
    assert len(batches) >= 2 and all(b == 2 * a for b, a in zip(batches, batches[1:]))
    loops = {key[0][0]: buf for g in cache.slots for key, buf in g.loops.items()}
    half = loops[batches[1]]
    graphs = (half.step_graph, half.sweep_graph)
    _, rep2 = jk_run(x, kt, JK)
    assert totals(rep2)["captures"] == 0
    assert (half.step_graph, half.sweep_graph) == graphs
    assert {key[0][0]: buf for g in cache.slots for key, buf in g.loops.items()}[batches[1]] is half
