"""The port's engine concurrency on the CPU in float64: the buckets of a
wave in ``bucket_threads`` threads (``solvers/cals.py``), against the JAX
engine's threaded default and against the port's own serial run; the trace
under threads; checkpoint and resume under threads; every result fetched
at once; a bucket's exception; ``precompile_buckets``; and
``utils/analysis.benchmark_dashboard`` against the JAX package's."""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu.utils.analysis import benchmark_dashboard as jax_dashboard
from cp_cals_tpu_torch import AlsParams, CalsParams, RandomKtensorSpec, cp_als, cp_cals, launches
from cp_cals_tpu_torch import random_ktensor_host
from cp_cals_tpu_torch.solvers import cals, graph_loop
from cp_cals_tpu_torch.utils.analysis import benchmark_dashboard
from cp_cals_tpu_torch.utils.timers import RunTrace

TOL = 1e-10  # against JAX
SELF_TOL = 1e-12  # threaded against serial
MODES = (8, 7, 6)
# Three buckets in one wave (budget 40 columns: 2 + 4 + 8 slots of 2, 4, 8).
BASE = dict(tol=1e-9, max_iterations=120, bucket_ranks=(2, 4, 8), buffer_size=40)


def make_problem(seed, n_models=12, ranks=(1, 2, 3, 4, 6, 7), noise=1e-3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + noise * rng.standard_normal(MODES)
    queue = [random_ktensor_host(rng, MODES, ranks[i % len(ranks)], dtype=np.float64) for i in range(n_models)]
    return x, queue


def run(x, queue, threads, **kw):
    """The port's run at ``threads`` bucket threads: (results, report, MTTKRP
    routes, the threads its buckets ran in)."""
    seen = set()
    real = graph_loop.pack_evict_stats

    def spy(state):
        seen.add(threading.current_thread().name)
        return real(state)

    launches.reset()
    graph_loop.pack_evict_stats = spy
    try:
        res, rep = cp_cals(x, queue, CalsParams(**{**BASE, "bucket_threads": threads, **kw.pop("params", {})}),
                           device="cpu", **kw)
    finally:
        graph_loop.pack_evict_stats = real
    return res, rep, launches.routes(), seen


def assert_close(a, b, tol, bits=False):
    (res_a, rep_a), (res_b, rep_b) = a, b
    assert [(m.id, m.rank, m.iters) for m in rep_a.models] == [(m.id, m.rank, m.iters) for m in rep_b.models]
    np.testing.assert_allclose([m.approx_error for m in rep_a.models], [m.approx_error for m in rep_b.models],
                               atol=tol)
    for ka, kb in zip(res_a, res_b):
        for fa, fb in zip(ka.factors + (ka.lam,), kb.factors + (kb.lam,)):
            if bits:
                np.testing.assert_array_equal(fa, np.asarray(fb))
            else:
                np.testing.assert_allclose(fa, np.asarray(fb), atol=tol)


def test_threaded_port_matches_jax_threaded_default():
    """Three buckets in 4 threads against the JAX engine at its default
    (4 bucket threads), at 1e-10 with equal iteration counts."""
    x, queue = make_problem(1)
    res, rep, _, seen = run(x, queue, 4)
    assert len(seen) == 3 and "MainThread" not in seen  # one thread a bucket
    assert jcfg.CalsParams().bucket_threads == 4
    jq = [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]
    jres, jrep = jax_cp_cals(jnp.asarray(x), jq, jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP,
                                                                 dimtree="off", **BASE))
    assert len(rep.engine_iterations) == 3
    assert_close((res, rep), (jres, jrep), TOL)


@pytest.mark.parametrize("kw", [
    {},
    dict(sync_mode="iter"),
    dict(force_max_iter=True, max_iterations=9, tail_compaction_depth=2),
    dict(tol_check_interval=5, polish_iters=2, polish_tol=1e-12, mttkrp_precision="default", line_search=True),
], ids=["tol", "iter", "forced-compaction", "checks-polish-ls"])
def test_threaded_matches_serial(kw):
    """The port threaded against the port serial: equal iteration counts,
    engine iterations, loop counts and MTTKRP routes, results at 1e-12 (and
    bit for bit: the buckets share nothing)."""
    x, queue = make_problem(2, n_models=16)
    queue[3] = RandomKtensorSpec(MODES, 3, seed=5, dtype="float64")  # a spec model among explicit ones
    serial = run(x, queue, 1, params=kw)
    threaded = run(x, queue, 4, params=kw)
    assert serial[3] == {"MainThread"} and len(threaded[3]) == 3
    assert_close(serial[:2], threaded[:2], SELF_TOL)
    assert_close(serial[:2], threaded[:2], 0.0, bits=True)
    assert serial[1].engine_iterations == threaded[1].engine_iterations
    assert serial[1].loop_counts == threaded[1].loop_counts
    assert serial[2] == threaded[2] and sum(serial[2].values()) > 0


def test_trace_in_evict_threaded_config():
    """tests/test_cals.py::test_trace_in_evict_threaded_config: the trace in
    the default configuration (the chunk loop, threaded buckets): one record
    per engine iteration, each bucket's in order, and the results those of
    cp_als."""
    x, kts = make_problem(10, n_models=8, ranks=(2, 3))
    params = CalsParams(tol=1e-9, buffer_size=16, bucket_ranks=(2, 4), sync_mode="evict", bucket_threads=4)
    trace = RunTrace()
    results, rep = cp_cals(x, kts, params, device="cpu", trace=trace)
    assert trace.records
    assert len(trace.records) == sum(rep.engine_iterations.values())
    for r, n in rep.engine_iterations.items():
        assert [t.iteration for t in trace.records if t.bucket == r] == list(range(1, n + 1))
    assert all(r.active_columns >= r.active_models for r in trace.records)
    assert {r.bucket for r in trace.records} == {2, 4}
    assert all(pt["solve"] > 0 for pt in rep.phase_times.values())
    for kt0, kt in zip(kts, results):
        kt_als, _ = cp_als(x, kt0, AlsParams(tol=1e-9), device="cpu")
        for fa, fb in zip(kt.factors, kt_als.factors):
            np.testing.assert_allclose(fa, np.asarray(fb), atol=TOL)


@pytest.mark.parametrize("sync_mode", ["evict", "iter"])
def test_checkpoint_and_resume_with_threads(tmp_path, sync_mode):
    """A threaded run cut after one eviction round per bucket and resumed,
    under checkpoint_dir, equals the uninterrupted threaded run bit for
    bit."""
    x, queue = make_problem(3, n_models=14)
    kw = dict(sync_mode=sync_mode)
    want = run(x, queue, 4, params=kw)
    part = run(x, queue, 4, params=kw, checkpoint_dir=str(tmp_path), max_rounds_per_bucket=1)
    assert any(k is None for k in part[0])
    got = run(x, queue, 4, params=kw, checkpoint_dir=str(tmp_path), resume=True)
    assert len(got[3]) == 3
    assert_close(want[:2], got[:2], 0.0, bits=True)


def test_materialize_s_and_every_result():
    """Every eviction round fetches its results at once, with and without
    checkpoint_dir: every result present (nothing is left to collect after
    the last bucket), the results and the stats fetches (one per chunk and
    per eviction round) the same."""
    x, queue = make_problem(4, n_models=16)
    res, rep, _, _ = run(x, queue, 4)
    assert all(k is not None for k in res)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        res_c, rep_c, _, _ = run(x, queue, 4, checkpoint_dir=d)
    assert all(k is not None for k in res_c)
    assert_close((res, rep), (res_c, rep_c), 0.0, bits=True)
    assert {r: c["stats_fetches"] for r, c in rep.loop_counts.items()} == \
        {r: c["stats_fetches"] for r, c in rep_c.loop_counts.items()}
    # With a half-width wire the payload rounds the factors, the stats stay
    # exact.
    res_w, rep_w, _, _ = run(x, queue, 4, params=dict(result_wire_dtype="float16"))
    assert [(m.iters, m.fit) for m in rep_w.models] == [(m.iters, m.fit) for m in rep.models]
    for a, b in zip(res_w, res):
        np.testing.assert_allclose(a.factors[0], b.factors[0], atol=1e-2)


def test_an_exception_in_one_bucket_raises_from_cp_cals(monkeypatch):
    """A bucket whose iteration raises: cp_cals raises that exception (no
    serial or other fallback), whichever thread ran the bucket."""
    real = cals.make_iteration

    def make(params, **kw):
        it = real(params, **kw)

        class Failing:
            prepare = staticmethod(it.prepare)

            def __call__(self, x, state, *a):
                if state.kt.factors[0].shape[-1] == 4:
                    raise RuntimeError("bucket of rank 4 failed")
                return it(x, state, *a)

        return Failing()

    monkeypatch.setattr(cals, "make_iteration", make)
    x, queue = make_problem(5)
    for threads in (1, 4):
        with pytest.raises(RuntimeError, match="bucket of rank 4 failed"):
            run(x, queue, threads)


def test_precompile_buckets_leaves_nothing_to_resolve(monkeypatch):
    """precompile_buckets resolves every bucket cp_cals resolves, with the
    same arguments (the table's keys, autotuned on the card where they
    miss), is idempotent, leaves no trace in the launch and route counts
    (its eager iterations of every bucket's program run MTTKRPs), and
    changes no result."""
    calls = []
    real = cals._resolve_bucket_methods

    def spy(*a, **kw):
        calls.append((a, tuple(sorted(kw.items()))))
        return real(*a, **kw)

    monkeypatch.setattr(cals, "_resolve_bucket_methods", spy)
    x, queue = make_problem(6)
    params = CalsParams(**BASE, precision="high", mttkrp_precision="default", polish_iters=1)
    before, _ = cp_cals(x, queue, params, device="cpu")
    calls.clear()
    launches.reset()
    cals.precompile_buckets(x, queue, params, device="cpu")
    assert sum(launches.routes().values()) == 0 and sum(launches.read().values()) == 0
    warm = set(calls)
    cals.precompile_buckets(x, queue, params, device="cpu")
    assert set(calls) == warm and len(calls) == 2 * len(warm) == 6
    calls.clear()
    after, _ = cp_cals(x, queue, params, device="cpu")
    assert set(calls) == warm
    for a, b in zip(before, after):
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_array_equal(fa, fb)


def test_precompile_buckets_warms_once(monkeypatch):
    """A process warms given shapes, methods and params once: a repeated
    precompile_buckets (the jackknife calls it before every engine call)
    runs no eager iteration again; other params warm anew."""
    warmed = []
    real = cals._warm_programs
    monkeypatch.setattr(cals, "_WARMED", set())
    monkeypatch.setattr(cals, "_warm_programs", lambda *a: warmed.append(a[3]) or real(*a))
    x, queue = make_problem(8)
    params = CalsParams(**BASE)
    for _ in range(3):
        cals.precompile_buckets(x, queue, params, device="cpu")
    assert len(warmed) == 1 and len(warmed[0]) == 3  # three buckets, warmed once
    cals.precompile_buckets(x, queue, CalsParams(**{**BASE, "polish_iters": 1}), device="cpu")
    assert len(warmed) == 2


def test_bucket_threads_leave_no_count_parts():
    """A bucket thread's counts join the common part when its bucket ends,
    so threaded calls leave no part per thread behind, and the totals
    stay the serial run's."""
    from cp_cals_tpu_torch.ops.mttkrp import ROUTES

    x, queue = make_problem(9, n_models=16)
    serial = run(x, queue, 1)[2]
    for _ in range(3):
        _, _, routes, seen = run(x, queue, 4)
        assert len(seen) == 3 and routes == serial
        assert set(ROUTES._parts) <= {threading.get_ident()}


def test_benchmark_dashboard_matches_jax(tmp_path):
    files = {
        "bench_tol_measured.json": dict(models_per_sec=120.5, mean_iters_ratio_vs_f64=1.02,
                                        median_abs_fit_delta_vs_f64=3e-7),
        "bench_jk_measured.json": dict(jk_replicates_per_sec=850.25, jk_tier="high"),
        "jk_fp32_vs_fp64.json": {"tiers": {"high": [dict(dtype_err_over_scatter_p99=0.1234)],
                                           "default": [dict(dtype_err_over_scatter_p99=1.5678),
                                                       dict(dtype_err_over_scatter_p99=0.004)]}},
        "scale_sweep_layout_policy.json": {"recompute": dict(models_per_sec=40.0, mttkrp_tflops=12.3),
                                           "note": "x", "auto": dict(wall_s=1.0)},
        "external_cpd.json": {"contenders": {"cals": dict(models_per_sec=99.0), "tensorly": {}},
                              "cross_check": {"a": 1e-6, "b": 3e-6}},
        "experiments.json": {"base": dict(speedup=3.14159), "jk": dict(speedup=2.71828), "n": 3},
    }
    assert benchmark_dashboard(str(tmp_path)) == jax_dashboard(str(tmp_path)) == {}
    for name, d in files.items():
        (tmp_path / name).write_text(json.dumps(d))
        assert benchmark_dashboard(str(tmp_path)) == jax_dashboard(str(tmp_path))
    got = benchmark_dashboard(str(tmp_path))
    assert set(got) == {"tol_leg", "jackknife", "jk_se_fidelity_p99", "scale_500", "external_cross_check",
                        "grid_6_1_speedup_vs_batched_als"}
    assert got["grid_6_1_speedup_vs_batched_als"] == {"base": 3.14, "jk": 2.72}


def test_benchmark_dashboard_defaults_to_the_harness_output():
    """The default directory is where the port's harness writes
    (``experiments.py --out``'s default under the repo root), never the
    JAX package's data/benchmarks (a TPU's numbers)."""
    import os

    from cp_cals_tpu_torch.utils import analysis

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert analysis.DEFAULT_BENCH_DIR == os.path.join(repo, "chiprun_out", "experiments")
    assert benchmark_dashboard() == benchmark_dashboard(analysis.DEFAULT_BENCH_DIR)
