"""Polish sweeps and mixed-tier stopping against the JAX package, on the CPU.

fp64, where the JAX run's tiers are equal, at the 1e-11 band of
tests/test_cals.py, on the configurations of its
``test_polish_iters_refines_converged_models``,
``test_polish_tol_converges_each_model`` and ``test_mixed_tier_tol_stopping``
(ALS and CALS), from the same explicit inits. fp32 with a bf16 MTTKRP tier
under the check at "highest" against JAX's fused configuration, at the band
of tests/test_torch_slice.py (5e-4 on fits, 5e-3 on factors). The pieces:
``extrapolated_delta``, the ``HiState`` carry and the predicated MTTKRP's
plain version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.als import cp_als as jax_cp_als
from cp_cals_tpu.solvers.als import cp_batched_als as jax_cp_batched_als
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu.solvers.iteration import extrapolated_delta as jax_extrapolated_delta
from cp_cals_tpu_torch import AlsParams, CalsParams, cp_als, cp_batched_als, cp_cals, random_ktensor_host
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.solvers import graph_loop
from cp_cals_tpu_torch.solvers.iteration import extrapolated_delta, make_iteration
from cp_cals_tpu_torch.solvers.state import HiState, init_state, tree_map, tree_where

TOL = 1e-11
MODES = (9, 8, 7)


def make_problem(seed, n_models, ranks, dtype=np.float64, noise=1e-3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=dtype)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + noise * rng.standard_normal(MODES)).astype(dtype)
    return x, [random_ktensor_host(rng, MODES, ranks[i % len(ranks)], dtype=dtype) for i in range(n_models)]


def jkt(kt):
    return JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def jax_cals_params(**kw):
    return jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", epilogue="xla", **kw)


def jax_als_params(**kw):
    return jcfg.AlsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", epilogue="xla", **kw)


def recon(kt):
    return np.einsum("ir,jr,kr,r->ijk", *(np.asarray(f) for f in kt.factors), np.asarray(kt.lam))


def assert_matches(res_p, rep_p, res_j, rep_j, tol_fit=TOL, tol_recon=TOL):
    assert len(res_p) == len(res_j)
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert (mp.id, mp.rank, mp.iters) == (mj.id, mj.rank, mj.iters)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=tol_fit)
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, atol=tol_fit, rtol=tol_fit)
        np.testing.assert_allclose(recon(kp), recon(kj), atol=tol_recon)


def fit_of(x, kt):
    return 1.0 - np.linalg.norm(x - recon(kt)) / np.linalg.norm(x)


# ------------------------------------------------------------------ polish


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
@pytest.mark.parametrize("n_polish", [1, 2])
def test_polish_iters_matches_jax(n_polish, epilogue):
    """test_polish_iters_refines_converged_models: converged models get
    extra sweeps at the end of each run-until-evict; iteration counts are
    the unpolished run's, and the fit does not fall."""
    x, kts = make_problem(6, 6, (2, 3, 4))
    kw = dict(tol=1e-7, max_iterations=40, bucket_ranks=(2, 4), buffer_size=12, sync_mode="evict")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts], jax_cals_params(polish_iters=n_polish, **kw))
    res_p, rep_p = cp_cals(x, kts, CalsParams(epilogue=epilogue, polish_iters=n_polish, **kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    res_0, rep_0 = cp_cals(x, kts, CalsParams(epilogue=epilogue, **kw), device="cpu")
    for k0, k1, m0, m1 in zip(res_0, res_p, rep_0.models, rep_p.models):
        assert m0.iters == m1.iters
        assert fit_of(x, k1) >= fit_of(x, k0) - 1e-9
    sweeps = sum(c["polish_sweeps"] for c in rep_p.loop_counts.values())
    rounds = sum(1 for _ in rep_p.models)  # at most one polish per evicted model's round
    assert 0 < sweeps <= n_polish * rounds and sweeps % n_polish == 0


@pytest.mark.parametrize("check_every", [1, 4, 25])
def test_polish_tol_matches_jax(check_every, monkeypatch):
    """test_polish_tol_converges_each_model: each model freezes at its own
    fixed point, at most polish_iters sweeps. How often the host reads the
    done flags changes nothing but the sweeps run past the last one."""
    monkeypatch.setattr(graph_loop, "POLISH_CHECK", check_every)
    x, kts = make_problem(23, 6, (2, 3, 4))
    kw = dict(tol=1e-6, max_iterations=60, bucket_ranks=(2, 4), buffer_size=12, sync_mode="evict",
              polish_iters=25, polish_tol=1e-9)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts], jax_cals_params(**kw))
    res_p, rep_p = cp_cals(x, kts, CalsParams(**kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    # One more plain sweep moves the polished fit by less than polish_tol's band.
    for kp in res_p:
        kt2, _ = cp_als(x, kp, AlsParams(tol=0.0, max_iterations=1, force_max_iter=True), device="cpu")
        assert abs(fit_of(x, kt2) - fit_of(x, kp)) < 1e-8


def test_polish_with_mixed_tiers_and_wire_matches_jax_fp32():
    """The fast-tier jackknife shape of the bench's --fast setting, cut
    down: bf16 MTTKRP, checks and polish at "highest", float16 wire,
    evict_batch, jackknife fibers; fp32 against JAX's fused configuration
    at test_torch_slice.py's band."""
    x, kts = make_problem(4, 6, (2, 3), dtype=np.float32, noise=1e-2)
    jk = [-1, 2, 5, -1, 0, 7]
    kw = dict(tol=1e-6, max_iterations=40, bucket_ranks=(4,), buffer_size=12, precision="highest",
              mttkrp_precision="default", tol_check_interval=5, polish_iters=25, polish_tol=1e-6,
              evict_batch=2, result_wire_dtype="float16")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts],
                               dataclasses.replace(jax_cals_params(**kw), epilogue="fused"), jk_fibers=jk)
    res_p, rep_p = cp_cals(x, kts, CalsParams(**kw), jk_fibers=jk, device="cpu")
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert mp.id == mj.id and abs(mp.iters - mj.iters) <= 5
        np.testing.assert_allclose(mp.fit, mj.fit, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(recon(kp), recon(kj), rtol=5e-3, atol=5e-3)


# ------------------------------------------------------------ mixed tiers


K = 5


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
def test_mixed_tier_cals_matches_jax(epilogue):
    """test_mixed_tier_tol_stopping's CALS run: small buffer, so eviction and
    refill with staggered slot phases; the reported fit is the checked one."""
    x, kts = make_problem(7, 9, (4,))
    kw = dict(tol=1e-8, max_iterations=500, bucket_ranks=(4,), buffer_size=16, tol_check_interval=K)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts], jax_cals_params(**kw))
    res_p, rep_p = cp_cals(x, kts, CalsParams(epilogue=epilogue, **kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    oracle = [cp_als(x, kt, AlsParams(tol=1e-8, max_iterations=500), device="cpu")[1] for kt in kts]
    for ro, m in zip(oracle, rep_p.models):
        assert ro.iters <= m.iters <= ro.iters + 2 * K


@pytest.mark.parametrize("evict_batch", [1, 4])
def test_mixed_tier_evict_batch_matches_jax(evict_batch):
    """test_evict_batch_invariance's mixed-tier leg (K = 3), deferred
    eviction included."""
    x, kts = make_problem(23, 8, (3, 5, 7))
    kw = dict(tol=1e-7, max_iterations=300, bucket_ranks=(4, 8), buffer_size=24, tol_check_interval=3,
              evict_batch=evict_batch)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts], jax_cals_params(**kw))
    res_p, rep_p = cp_cals(x, kts, CalsParams(**kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)


def test_mixed_tier_als_matches_jax():
    """test_mixed_tier_tol_stopping's single-model ALS run, and the batched
    ALS driver with its frozen models."""
    x, kts = make_problem(7, 3, (4,))
    p = dict(tol=1e-8, max_iterations=500, tol_check_interval=K)
    kt_j, r_j = jax_cp_als(jnp.asarray(x), jkt(kts[0]), jax_als_params(**p))
    kt_p, r_p = cp_als(x, kts[0], AlsParams(**p), device="cpu")
    assert r_p.iters == r_j.iters and r_p.converged == r_j.converged
    np.testing.assert_allclose(r_p.fit, r_j.fit, atol=TOL)
    np.testing.assert_allclose(recon(kt_p), recon(kt_j), atol=TOL)
    res_j, reps_j = jax_cp_batched_als(jnp.asarray(x), [jkt(k) for k in kts], jax_als_params(**p))
    res_p, reps_p = cp_batched_als(x, kts, AlsParams(**p), device="cpu")
    for kp, kj, rp, rj in zip(res_p, res_j, reps_p, reps_j):
        assert rp.iters == rj.iters
        np.testing.assert_allclose(rp.fit, rj.fit, atol=TOL)
        np.testing.assert_allclose(recon(kp), recon(kj), atol=TOL)


def test_mixed_tier_jk_batched_als_matches_jax():
    from cp_cals_tpu.solvers import jackknife as jjk
    from cp_cals_tpu_torch import jk_cp_batched_als

    x, (kt0,) = make_problem(9, 1, (3,))
    kt_fit, _ = cp_als(x, kt0, AlsParams(tol=1e-10, max_iterations=200), device="cpu")
    p = dict(tol=1e-9, max_iterations=60, tol_check_interval=3)
    got = jk_cp_batched_als(x, [kt_fit], AlsParams(**p), device="cpu")
    want = jjk.jk_cp_batched_als(jnp.asarray(x), [jkt(kt_fit)], jax_als_params(**p))
    for a, b in zip(got.results[0], want.results[0]):
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            fb = np.asarray(fb)
            ok = np.isfinite(fb)
            assert (np.isfinite(fa) == ok).all()
            np.testing.assert_allclose(fa[ok], fb[ok], atol=1e-8)


# ------------------------------------------------------------------ pieces


def test_extrapolated_delta_matches_jax():
    rng = np.random.default_rng(0)
    rate = np.concatenate([rng.uniform(-1e-4, 1e-3, 200), [0.0, 1e-7, 3e-5, -1e-5]])
    prev = np.concatenate([rng.uniform(-1e-4, 1e-3, 200), [2e-5, 1e-1, 2e-5, 2e-5]])
    gap = np.concatenate([rng.integers(1, 12, 200), [3, 3, 3, 3]]).astype(np.float64)
    got = extrapolated_delta(torch.from_numpy(rate), torch.from_numpy(prev), torch.from_numpy(gap))
    want = jax_extrapolated_delta(jnp.asarray(rate), jnp.asarray(prev), jnp.asarray(gap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-300)


def test_hi_state_is_carried_and_selected():
    rng = np.random.default_rng(1)
    from cp_cals_tpu_torch.ktensor import Ktensor

    kt = Ktensor(tuple(torch.from_numpy(rng.normal(size=(3, m, 2))) for m in MODES),
                 torch.from_numpy(rng.normal(size=(3, 2))))
    st = init_state(kt, 2.0, mixed_tol=True)
    assert isinstance(st.hi, HiState) and st.hi.iters_prev.dtype == torch.int32
    assert init_state(kt, 2.0).hi == ()
    other = tree_map(lambda t: t + 1, st)
    sel = tree_where(torch.tensor([True, False, True]), other, st)
    np.testing.assert_array_equal(sel.hi.iters_prev.numpy(), [1, 0, 1])
    np.testing.assert_array_equal(sel.hi.fit_prev.numpy(), [1.0, 0.0, 1.0])


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_iteration_holds_the_check_tier_layouts(tier):
    """With the check (or polish) on, prepare also holds X at `precision`:
    the same tuple where the tiers agree."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=MODES).astype(np.float32))
    held = make_iteration(CalsParams(precision="high", mttkrp_precision=tier, tol_check_interval=3)).prepare(x)
    for mode in range(3):
        assert torch.equal(held[mode], fm.prepare_mode_tensor(x, mode, tier))
        assert torch.equal(held.hi[mode], fm.prepare_mode_tensor(x, mode, "high"))
    assert (held.hi is held) == (tier == "high")
    assert make_iteration(CalsParams(mttkrp_precision=tier)).prepare(x).hi is None


def test_predicated_mttkrp_plain_version_computes():
    """On the CPU the predicate is ignored (both branches are computed and
    the iteration selects), and no launch is counted."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=MODES).astype(np.float32))
    fs = [torch.from_numpy(rng.normal(size=(2, m, 3)).astype(np.float32)) for m in MODES]
    before = (fm.fused_mttkrp_tc.launches, fm.fused_mttkrp_tc.predicated)
    for p in (0, 1):
        got = fm.mttkrp_batched_fused(x, fs, 2, precision="default", pred=torch.tensor([p], dtype=torch.int32))
        assert torch.equal(got, fm.mttkrp_batched_fused(x, fs, 2, precision="default"))
    assert (fm.fused_mttkrp_tc.launches, fm.fused_mttkrp_tc.predicated) == before
