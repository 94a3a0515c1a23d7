"""The engine's bucket loops on the CPU (``solvers/graph_loop.py``).

- The chunked run-until-evict loop gives every model the fit, iteration
  count and factors of the per-iteration loop (``sync_mode="iter"``) bit
  for bit, at chunk lengths 1, 3 and 7, under forced iterations and
  tol-driven stops, with ``evict_batch`` 1 and 3, and with refills, given
  an MTTKRP whose bits do not depend on a model's slot.
- Its chunk policy runs no iteration past a forced convergence.
- ``sync_mode="iter"``, ``always_evict_first`` and ``max_rounds_per_bucket``
  against the JAX engine in fp64 at the 1e-11 band of tests/test_cals.py.
- The per-mode fused-epilogue gate: a mode forced off the fused path gives
  the unfused path's results.
- |X| reduced in float64, and the host transfers (pinned uploads, the
  packed eviction payload).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu_torch import CalsParams, cp_cals, launches, random_ktensor_host
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.solvers import graph_loop
from cp_cals_tpu_torch.solvers import iteration as piter

TOL = 1e-11
MODES = (9, 8, 7)


def make_problem(seed, ranks, dtype=np.float64, noise=1e-3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=dtype)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + noise * rng.standard_normal(MODES)).astype(dtype)
    return x, [random_ktensor_host(rng, MODES, r, dtype=dtype) for r in ranks]


def jax_queue(queue):
    return [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]


def jax_params(**kw):
    return jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", epilogue="xla", **kw)


def assert_bit_identical(res_a, rep_a, res_b, rep_b):
    assert [m.id for m in rep_a.models] == [m.id for m in rep_b.models]
    for a, b, ma, mb in zip(res_a, res_b, rep_a.models, rep_b.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


RANKS = (1, 2, 3, 4, 5, 6, 2, 3, 4, 1)  # 10 models over buckets 2/4/8 of 12 columns: refills
LOOP_CASES = {
    "forced": dict(max_iterations=12, force_max_iter=True),
    "tol_evict1": dict(tol=1e-9),
    "tol_evict3": dict(tol=1e-9, evict_batch=3),
}


def mttkrp_per_model(x3, u1, u2, precision, plain=fm.fused_mttkrp_plain):
    """The plain MTTKRP as one product per model: a model's bits do not
    depend on its slot or on the batch (one product of all B*R columns, as
    in ``fused_mttkrp_plain``, may round a column by its position)."""
    return torch.cat([plain(x3, u1[s : s + 1], u2[s : s + 1], precision) for s in range(u1.shape[0])])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_chunked_loop_is_bit_identical_to_the_iter_loop(chunk, case, dtype, monkeypatch):
    """Models that converge inside a chunk are frozen, so the chunk only
    moves when they are evicted and refilled; with an MTTKRP that gives a
    model the same bits in any slot, each model's results are the
    per-iteration loop's, bit for bit (fp32 at its own tol)."""
    monkeypatch.setattr(fm, "fused_mttkrp_plain", mttkrp_per_model)
    x, queue = make_problem(5, RANKS, dtype)
    kw = dict(LOOP_CASES[case])
    if dtype == np.float32 and "tol" in kw:
        kw["tol"] = 1e-6
    base = CalsParams(buffer_size=12, bucket_ranks=(2, 4, 8), **kw)
    ref, rep_ref = cp_cals(x, queue, dataclasses.replace(base, sync_mode="iter"), device="cpu")
    monkeypatch.setattr(graph_loop, "chunk_length", lambda *a: chunk)
    got, rep_got = cp_cals(x, queue, base, device="cpu")
    assert_bit_identical(ref, rep_ref, got, rep_got)
    if chunk == 1 and "evict_batch" not in kw:
        assert rep_got.engine_iterations == rep_ref.engine_iterations


@pytest.mark.parametrize("tail", [0, 2])
def test_forced_chunks_end_at_the_first_forced_convergence(tail):
    """Under force_max_iter the policy knows every slot's count: the loop
    runs exactly the per-iteration loop's iterations, with one stats fetch
    per chunk and one per eviction round."""
    x, queue = make_problem(6, RANKS)
    base = CalsParams(max_iterations=7, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4, 8),
                      tail_compaction_depth=tail)
    ref, rep_ref = cp_cals(x, queue, dataclasses.replace(base, sync_mode="iter"), device="cpu")
    got, rep_got = cp_cals(x, queue, base, device="cpu")
    assert_bit_identical(ref, rep_ref, got, rep_got)
    assert rep_got.engine_iterations == rep_ref.engine_iterations
    for r, counts in rep_got.loop_counts.items():
        assert counts["captures"] == counts["replays"] == 0  # no graphs on the CPU
        assert counts["stats_fetches"] < rep_ref.loop_counts[r]["stats_fetches"]


def test_chunk_policy():
    p = CalsParams(max_iterations=10, force_max_iter=True)
    live = np.array([True, True, False])
    assert graph_loop.chunk_length(p, np.array([3, 6, 9]), live) == 4
    p = CalsParams(max_iterations=10, tol_check_interval=5)
    assert graph_loop.chunk_length(p, np.array([3, 1, 0]), live) == 1  # to the oldest's pre-check at 4
    assert graph_loop.chunk_length(p, np.array([4, 1, 0]), live) == 1  # then its decision check at 5
    assert graph_loop.chunk_length(p, np.array([5, 1, 0]), live) == 4
    p = CalsParams(max_iterations=10, tol_check_interval=3)
    assert graph_loop.chunk_length(p, np.array([9, 1, 0]), live) == 1  # capped at max_iterations
    assert graph_loop.chunk_length(dataclasses.replace(p, max_iterations=20), np.array([9, 1, 0]), live) == 2
    p = CalsParams(max_iterations=100)
    assert graph_loop.chunk_length(p, np.array([3, 1, 0]), live) == graph_loop.TOL_CHUNK


@pytest.mark.parametrize("case", [
    dict(ranks=(1, 2, 3, 4, 5, 6, 2, 3), jk=(-1, 3, -1, 0, 8, -1, -1, 2),
         kw=dict(max_iterations=12, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4, 8))),
    dict(ranks=(1, 2, 3, 4, 3, 2), jk=None, kw=dict(tol=1e-9, buffer_size=8, bucket_ranks=(2, 4))),
    dict(ranks=(3, 4, 2, 3), jk=None, kw=dict(tol=1e-9, buffer_size=8, bucket_ranks=(4,), evict_batch=3)),
], ids=["forced_jk_refill", "tol_driven", "evict_batch_ignored"])
def test_iter_mode_matches_jax(case):
    """sync_mode="iter" is the JAX package's per-iteration mode: every
    converged model leaves at once (evict_batch does not apply)."""
    x, queue = make_problem(1, case["ranks"])
    jk = list(case["jk"]) if case["jk"] else None
    kw = dict(case["kw"], sync_mode="iter")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(**kw), jk_fibers=jk)
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), jk_fibers=jk, device="cpu")
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert (mp.id, mp.iters) == (mj.id, mj.iters)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=TOL)
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            np.testing.assert_allclose(fp, np.asarray(fj), atol=1e-9)
    assert rep_p.engine_iterations == rep_j.engine_iterations


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
def test_always_evict_first_matches_jax(epilogue):
    """The configuration of tests/test_cals.py::test_always_evict_first_and_trace
    without its trace: the leftmost occupied slot leaves every iteration,
    converged or not, and converged models in other slots iterate on."""
    x, queue = make_problem(5, (3, 3, 3, 3, 3))
    kw = dict(max_iterations=50, always_evict_first=True, bucket_ranks=(4,), buffer_size=8,
              sync_mode="iter")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(**kw))
    res_p, rep_p = cp_cals(x, queue, CalsParams(epilogue=epilogue, **kw), device="cpu")
    assert len(res_p) == 5 and all(k is not None for k in res_p)
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert (mp.id, mp.iters) == (mj.id, mj.iters)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=TOL)
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, atol=TOL)
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            np.testing.assert_allclose(fp, np.asarray(fj), atol=1e-9)
    assert rep_p.engine_iterations == rep_j.engine_iterations


@pytest.mark.parametrize("sync_mode", ["evict", "iter"])
@pytest.mark.parametrize("rounds", [1, 2])
def test_max_rounds_per_bucket_matches_jax(rounds, sync_mode):
    """Each bucket stops after that many eviction rounds; unfinished models
    are None exactly where the JAX engine leaves them None."""
    x, queue = make_problem(8, (2, 3, 2, 3, 2, 3, 2, 3, 2, 3))
    kw = dict(tol=1e-9, buffer_size=16, bucket_ranks=(4,), sync_mode=sync_mode)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(**kw),
                               max_rounds_per_bucket=rounds)
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), device="cpu", max_rounds_per_bucket=rounds)
    assert [k is None for k in res_p] == [k is None for k in res_j]
    assert any(k is None for k in res_p) and any(k is not None for k in res_p)
    assert [m.id for m in rep_p.models] == [m.id for m in rep_j.models]
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert mp.iters == mj.iters
        if kp is not None:
            np.testing.assert_allclose(kp.lam, np.asarray(kj.lam), atol=1e-9)


@pytest.mark.parametrize("off", [(0,), (1,), (2,), (0, 1, 2)], ids=["mode0", "mode1", "mode2", "all"])
def test_mode_off_the_fused_path_takes_the_unfused_path(off, monkeypatch):
    """The gate sends a mode whose shape the kernels refuse to the unfused
    path (the last mode's error then comes from fast_error). Forced off by
    a patched gate: every mode off gives the unfused run bit for bit; one
    mode off stays in the 1e-11 band of the unfused run."""
    x, queue = make_problem(3, (1, 2, 3, 4, 3))
    kw = dict(max_iterations=10, force_max_iter=True, buffer_size=8, bucket_ranks=(2, 4))
    jk = [-1, 2, -1, 0, 5]
    want, rep_w = cp_cals(x, queue, CalsParams(epilogue="xla", **kw), jk_fibers=jk, device="cpu")
    real = fe.supports_fused_epilogue
    seen = []

    def gate(b, i_n, r, dtype, n_modes, device):
        seen.append(i_n)
        return MODES.index(i_n) not in off and real(b, i_n, r, dtype, n_modes, device)

    monkeypatch.setattr(piter, "supports_fused_epilogue", gate)
    apply_calls = []
    real_apply = piter.epilogue_apply
    monkeypatch.setattr(piter, "epilogue_apply", lambda g, *a, **k: apply_calls.append(g.shape[1]) or
                        real_apply(g, *a, **k))
    got, rep_g = cp_cals(x, queue, CalsParams(epilogue="fused", **kw), jk_fibers=jk, device="cpu")
    assert set(seen) == set(MODES)
    assert set(apply_calls) == {m for n, m in enumerate(MODES) if n not in off}
    if len(off) == 3:
        assert_bit_identical(want, rep_w, got, rep_g)
    for a, b, ma, mb in zip(want, got, rep_w.models, rep_g.models):
        assert ma.iters == mb.iters
        np.testing.assert_allclose(mb.fit, ma.fit, atol=TOL)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_allclose(fb, fa, atol=1e-9)


def test_fused_gate_is_true_on_the_cpu():
    for args in [(4, 3000, 20), (2, 9, 65), (1, 1, 128)]:
        assert fe.supports_fused_epilogue(*args, torch.float64, 4, "cpu")


def test_counted_wrappers_are_every_wrapper_with_a_launch_count():
    """``launches.counted`` names every function of the port that keeps a
    launch count (a ``launches.Wrapper``), so a replay advances them all."""
    import importlib
    import pkgutil

    import cp_cals_tpu_torch

    found = {}
    for info in pkgutil.walk_packages(cp_cals_tpu_torch.__path__, "cp_cals_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if isinstance(obj, launches.Wrapper) and getattr(obj, "__module__", None) == info.name:
                found[name] = obj
    assert found == launches.counted()


@pytest.mark.parametrize("replays", [0, 1, 5])
def test_a_capture_counts_once_per_replay(replays):
    """What a capture adds to the wrappers' counts and to a tally is put
    back and added again per replay (``graph_loop.Graph``)."""
    fm_fp32, fe_apply = launches.counted()["fused_mttkrp_fp32"], launches.counted()["epilogue_apply"]
    launches.reset()
    tally = launches.Tally({("B", 4): 2})
    launches.TALLIES.append(tally)
    try:
        before = launches.snapshot()
        fm_fp32.launches += 3  # what a capture's Python calls count
        fm_fp32.predicated += 1
        fe_apply.launches += 3
        tally[("B", 4)] += 3
        tally[("B", 2)] = 1
        added = launches.take_added(before)
        assert launches.read()["fused_mttkrp_fp32"] == 0 and tally == {("B", 4): 2}
        launches.add(added, replays)
        counts = launches.read()
        assert counts["fused_mttkrp_fp32"] == counts["epilogue_apply"] == 3 * replays
        assert counts["fused_mttkrp_fp32.predicated"] == replays and counts["normal_inverse"] == 0
        assert tally == {("B", 4): 2 + 3 * replays, ("B", 2): replays}
    finally:
        launches.TALLIES.remove(tally)
        launches.reset()


def test_pinned_upload_and_fetch_on_the_cpu():
    from cp_cals_tpu_torch.solvers.cals import _evicted_payload, _split_payload
    from cp_cals_tpu_torch.solvers.state import init_state
    from cp_cals_tpu_torch.ktensor import Ktensor

    p = graph_loop.Pinned(torch.device("cpu"))
    data = np.arange(12, dtype=np.int64).reshape(2, 6)
    assert torch.equal(p.upload(data), torch.from_numpy(data))
    rng = np.random.default_rng(0)
    kt = Ktensor(tuple(torch.from_numpy(rng.normal(size=(3, m, 4))) for m in MODES),
                 torch.from_numpy(rng.normal(size=(3, 4))))
    st = init_state(kt, 2.0)
    idx = torch.tensor([[0, 0, 2], [1, 3, 0]])
    for wire in (None, "float16", "bfloat16"):
        flat, layout = _evicted_payload(st, idx, wire)
        stats, lam, *fs = _split_payload(p.fetch(flat), layout)
        np.testing.assert_array_equal(stats, graph_loop.pack_evict_stats(st).numpy())
        np.testing.assert_array_equal(lam, kt.lam[idx[0], idx[1]].numpy())
        for f, full in zip(fs, kt.factors):
            want = full[idx[0], :, idx[1]]
            if wire is not None:
                want = want.to(getattr(torch, wire)).float()
            np.testing.assert_array_equal(f, want.numpy())


def test_x_norm_reduces_in_float64():
    """|X| of a float32 tensor of millions of entries: a float32 sum of
    squares on the CPU drifted by 3e-4 relative (0.991 reported for a true
    fit of 0.969 at 3000 x 64 x 48); reduced in float64 it is |X| rounded
    once, and the engine's reported error is the dense error's."""
    from cp_cals_tpu_torch.solvers.cals import _norms

    rng = np.random.default_rng(20)
    modes = (3000, 64, 48)
    kt = random_ktensor_host(rng, modes, 3)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    want = np.linalg.norm(x.astype(np.float64))
    got, _ = _norms(torch.from_numpy(x), False)
    assert got.dtype == torch.float32 and abs(got.item() - want) <= 1e-7 * want
    queue = [random_ktensor_host(rng, modes, 3)]
    res, rep = cp_cals(x, queue, CalsParams(max_iterations=3, force_max_iter=True), device="cpu")
    k = res[0]
    dense = np.einsum("ir,jr,kr,r->ijk", *(f.astype(np.float64) for f in k.factors), k.lam.astype(np.float64))
    true = np.linalg.norm(x.astype(np.float64) - dense)
    assert abs(rep.models[0].approx_error - true) <= 1e-3 * true
