"""Checkpoint/resume and the per-iteration trace of the port's engine, on
the CPU in float64: the state's round trip, the engine's files, resume
equal to the uninterrupted run in both bucket loops and through the
jackknife driver, and the trace's records against the JAX engine's."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu.utils.timers import RunTrace as JRunTrace
from cp_cals_tpu_torch import AlsParams, CalsParams, Ktensor, MttkrpMethod, cp_als, cp_cals, jk_cp_cals
from cp_cals_tpu_torch import random_ktensor_host
from cp_cals_tpu_torch.ktensor import to_tensor
from cp_cals_tpu_torch.solvers.jackknife import generate_jk_ktensors, to_host_model
from cp_cals_tpu_torch.solvers.state import init_state, tree_leaves
from cp_cals_tpu_torch.utils.checkpoint import load_state, save_state
from cp_cals_tpu_torch.utils.timers import RunTrace

TOL = 1e-10
MODES = (7, 6, 5)


def make_problem(seed, n_models, ranks, noise=1e-3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 2, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + noise * rng.standard_normal(MODES)
    queue = [random_ktensor_host(rng, MODES, ranks[i % len(ranks)], dtype=np.float64) for i in range(n_models)]
    return x, queue


def recon(kt):
    return to_tensor(Ktensor(tuple(torch.as_tensor(np.array(f)) for f in kt.factors),
                             torch.as_tensor(np.array(kt.lam)))).numpy()


def assert_same(want, rep_w, got, rep_g, tol=TOL):
    assert all(k is not None for k in got)
    for ma, mb in zip(rep_w.models, rep_g.models):
        assert (ma.id, ma.rank, ma.iters) == (mb.id, mb.rank, mb.iters)
        np.testing.assert_allclose(ma.approx_error, mb.approx_error, atol=tol)
    for a, b in zip(want, got):
        np.testing.assert_allclose(recon(a), recon(b), atol=tol)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_allclose(fa, fb, atol=tol)


@pytest.mark.parametrize("carries", [{}, dict(nnls=True, line_search=True, mixed_tol=True)],
                         ids=["plain", "nnls-ls-hi"])
def test_state_round_trip(tmp_path, carries):
    rng = np.random.default_rng(0)
    f = tuple(torch.from_numpy(rng.standard_normal((3, m, 4))) for m in MODES)
    kt = Ktensor(f, torch.from_numpy(rng.standard_normal((3, 4))))
    st = init_state(kt, torch.tensor(12.5, dtype=torch.float64), jk_fiber=torch.tensor([-1, 2, 0]), **carries)
    st = st._replace(iters=torch.tensor([1, 5, 9], dtype=torch.int32), converged=torch.tensor([True, False, True]))
    p = str(tmp_path / "ck")
    save_state(p, st, {"round": 3})
    back, meta = load_state(p, st)
    assert meta == {"round": 3}
    assert type(back) is type(st) and back._fields == st._fields
    for a, b in zip(tree_leaves(st), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    side = json.load(open(p + ".meta.json"))
    assert side["n_leaves"] == len(tree_leaves(st)) and side["treedef"].startswith("SolverState(kt=Ktensor(")


def test_mismatched_leaf_count_raises(tmp_path):
    kt = Ktensor(tuple(torch.zeros((2, m, 3), dtype=torch.float64) for m in MODES), torch.zeros((2, 3)))
    x_norm = torch.tensor(1.0, dtype=torch.float64)
    p = str(tmp_path / "ck")
    save_state(p, init_state(kt, x_norm, line_search=True))
    with pytest.raises(ValueError, match="state leaves"):
        load_state(p, init_state(kt, x_norm))
    kt3 = Ktensor(tuple(torch.zeros((3, m, 3), dtype=torch.float64) for m in MODES), torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state(p, init_state(kt3, x_norm, line_search=True))


def test_engine_checkpoint_files(tmp_path):
    """tests/test_cals.py's check: a bucket's snapshot and its metadata
    (the JAX engine's files and keys)."""
    x, kts = make_problem(7, n_models=4, ranks=(3,))
    params = CalsParams(max_iterations=6, force_max_iter=True, bucket_ranks=(4,))
    cp_cals(x, kts, params, device="cpu", checkpoint_dir=str(tmp_path))
    files = os.listdir(tmp_path)
    assert {"bucket_r4.npz", "bucket_r4.meta.json", "done_r4.npz"} <= set(files)
    meta = json.load(open(tmp_path / "bucket_r4.meta.json"))["meta"]
    assert meta["bucket_rank"] == 4
    assert sorted(m[0] for m in meta["done"]) == [0, 1, 2, 3]
    assert all(m is None for m in meta["slot_meta"])
    with np.load(tmp_path / "done_r4.npz") as done:
        assert set(done.files) == {f"{i}_{k}" for i in range(4) for k in ("f0", "f1", "f2", "lam")}


@pytest.mark.parametrize("sync_mode", ["evict", "iter"])
def test_checkpoint_resume(tmp_path, sync_mode):
    """tests/test_cals.py's kill-and-resume in each bucket loop: finished
    models from the done archive, in-flight ones mid-solve, the rest
    fitted; the resumed run equals the uninterrupted one."""
    x, kts = make_problem(8, n_models=10, ranks=(2, 3))
    params = CalsParams(tol=1e-9, buffer_size=16, bucket_ranks=(4,), sync_mode=sync_mode)
    want, rep_w = cp_cals(x, kts, params, device="cpu")
    part, _ = cp_cals(x, kts, params, device="cpu", checkpoint_dir=str(tmp_path), max_rounds_per_bucket=1)
    assert any(k is None for k in part), "run should have been interrupted"
    assert sum(k is not None for k in part) >= 1
    got, rep_g = cp_cals(x, kts, params, device="cpu", checkpoint_dir=str(tmp_path), resume=True)
    assert_same(want, rep_w, got, rep_g)


def test_resume_after_tail_compaction(tmp_path):
    """Snapshots are taken after compaction: a run cut at every round and
    resumed round by round reaches the uninterrupted results."""
    x, kts = make_problem(9, n_models=6, ranks=(3, 2))
    params = CalsParams(tol=1e-9, buffer_size=32, bucket_ranks=(4,), max_iterations=60)
    want, rep_w = cp_cals(x, kts, params, device="cpu")
    d = str(tmp_path)
    got, rep = cp_cals(x, kts, params, device="cpu", checkpoint_dir=d, max_rounds_per_bucket=1)
    for _ in range(10):
        if all(k is not None for k in got):
            break
        got, rep = cp_cals(x, kts, params, device="cpu", checkpoint_dir=d, resume=True, max_rounds_per_bucket=1)
    assert_same(want, rep_w, got, rep)


def test_jk_checkpoint_resume(tmp_path):
    """tests/test_jackknife.py's check: a checkpointed jackknife equals the
    plain one, a resume from its finished archive refits nothing and
    equals it too, and an interrupted jackknife-fibered engine run resumes
    exactly."""
    rng = np.random.default_rng(23)
    kt = random_ktensor_host(rng, MODES, 2, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(MODES)
    kt_fit, _ = cp_als(x, random_ktensor_host(rng, MODES, 2, dtype=np.float64),
                       AlsParams(tol=1e-10, max_iterations=300), device="cpu")
    params = CalsParams(max_iterations=12, force_max_iter=True, bucket_ranks=(2,), buffer_size=4)
    a = jk_cp_cals(x, [kt_fit], params, device="cpu")
    b = jk_cp_cals(x, [kt_fit], params, device="cpu", checkpoint_dir=str(tmp_path))
    c = jk_cp_cals(x, [kt_fit], params, device="cpu", checkpoint_dir=str(tmp_path), resume=True)
    assert sum(c.cals_report.engine_iterations.values()) == 0  # nothing refitted
    for ra, rb, rc in zip(a.results[0], b.results[0], c.results[0]):
        for fa, fb, fc in zip(ra.factors, rb.factors, rc.factors):
            mask = np.isfinite(fa)
            np.testing.assert_allclose(fa[mask], fb[mask], atol=TOL)
            np.testing.assert_allclose(fa[mask], fc[mask], atol=TOL)

    reps = generate_jk_ktensors(to_host_model(kt_fit))
    queue, fibers = [k for k, _ in reps], [f for _, f in reps]
    d2 = str(tmp_path / "interrupt")
    want, rep_w = cp_cals(x, queue, params, jk_fibers=fibers, device="cpu")
    part, _ = cp_cals(x, queue, params, jk_fibers=fibers, device="cpu", checkpoint_dir=d2,
                      max_rounds_per_bucket=1)
    assert any(k is None for k in part)
    got, rep_g = cp_cals(x, queue, params, jk_fibers=fibers, device="cpu", checkpoint_dir=d2, resume=True)
    assert_same(want, rep_w, got, rep_g)


# ------------------------------------------------------------------ trace


def records(trace) -> list[tuple]:
    return sorted((r.bucket, r.iteration, r.active_models, r.active_columns, r.flops) for r in trace.records)


def jax_run(x, queue, **kw):
    jq = [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]
    trace = JRunTrace()
    params = jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", bucket_threads=1, **kw)
    jax_cp_cals(jnp.asarray(x), jq, params, trace=trace)
    return trace


def test_trace_matches_jax_iter_loop():
    """tests/test_cals.py's always_evict_first trace (sync_mode="iter"):
    one record per iteration from the host, equal to JAX's."""
    x, kts = make_problem(5, n_models=5, ranks=(3,))
    kw = dict(max_iterations=50, always_evict_first=True, bucket_ranks=(4,), buffer_size=8, sync_mode="iter")
    trace = RunTrace()
    results, rep = cp_cals(x, kts, CalsParams(mttkrp_method=MttkrpMethod.TWOSTEP, **kw), device="cpu",
                           trace=trace)
    assert len(results) == 5 and len(trace.records) >= 5
    assert trace.records[0].active_columns > 0
    assert records(trace) == records(jax_run(x, kts, **kw))
    assert all(pt["solve"] > 0 for pt in rep.phase_times.values())


def test_trace_matches_jax_forced_chunk_loop():
    """Forced iterations in the chunk loop: each chunk ends at the first
    forced convergence, as JAX's device loop does, so the device-side
    records equal JAX's; tracing fetches nothing more and moves no
    result."""
    x, kts = make_problem(10, n_models=9, ranks=(1, 2, 3))
    kw = dict(max_iterations=7, force_max_iter=True, bucket_ranks=(2, 4), buffer_size=10)
    trace = RunTrace()
    params = CalsParams(mttkrp_method=MttkrpMethod.TWOSTEP, **kw)
    res_t, rep_t = cp_cals(x, kts, params, device="cpu", trace=trace)
    assert records(trace) == records(jax_run(x, kts, **kw))
    res_u, rep_u = cp_cals(x, kts, params, device="cpu")
    assert len(trace.records) == sum(rep_t.engine_iterations.values())
    assert rep_t.loop_counts == rep_u.loop_counts
    for a, b in zip(res_t, res_u):
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_array_equal(fa, fb)


def test_trace_counts_every_engine_iteration():
    """Tol-driven chunks may run past JAX's loop exit (frozen models): the
    records are one per iteration the port ran, engine_iterations of them
    per bucket, each counting live models and their true columns. An
    iteration a chunk runs after its last live model converged counts none
    (JAX's loop would have stopped before it)."""
    x, kts = make_problem(11, n_models=8, ranks=(2, 3))
    params = CalsParams(tol=1e-9, buffer_size=16, bucket_ranks=(2, 4))
    trace = RunTrace()
    results, rep = cp_cals(x, kts, params, device="cpu", trace=trace)
    for r, n in rep.engine_iterations.items():
        mine = [t for t in trace.records if t.bucket == r]
        assert len(mine) == n and [t.iteration for t in mine] == list(range(1, n + 1))
    assert all(r.active_columns >= r.active_models >= 0 for r in trace.records)
    assert all(r.active_models >= 1 for r in trace.records if r.iteration == 1)
    assert any(r.active_models == 0 for r in trace.records)  # this run's chunks run past a stop
    assert {r.bucket for r in trace.records} == {2, 4}
    for kt0, kt in zip(kts, results):
        kt_als, _ = cp_als(x, kt0, AlsParams(tol=1e-9), device="cpu")
        np.testing.assert_allclose(recon(kt), recon(kt_als), atol=TOL)
