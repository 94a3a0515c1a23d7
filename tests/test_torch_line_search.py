"""The port's line searches (NO_ERROR_CHECKING and ERROR_CHECKING) and the
debug monotonicity hook, against the JAX package on the CPU in float64.

- ``cp_cals`` with each method, with NNLS, through eviction and refill,
  against JAX's ``cp_cals`` at 1e-10 and the port's own ``cp_als``
  (``test_cals_line_search_equals_als``,
  ``test_cals_nnls_line_search_equals_als``); ``cp_als`` and
  ``cp_batched_als`` against JAX.
- Mixed-tier stopping with NEC line search
  (``test_mixed_tier_with_line_search_no_blind_eviction``): against JAX,
  and no model returned at a blind extrapolation.
- The chunked loop against the iter loop, bit for bit.
- ``jk_cp_cals`` with line search against JAX's and the subsampled ALS
  oracle (``test_jk_line_search_equals_subsampled_als``).
- The debug hook's entries equal JAX's, in order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
import cp_cals_tpu.solvers.iteration as jiter
import cp_cals_tpu.solvers.jackknife as jjk
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.als import cp_als as jax_cp_als
from cp_cals_tpu.solvers.als import cp_batched_als as jax_cp_batched_als
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu.solvers.state import init_state as jax_init_state
from cp_cals_tpu_torch import (
    AlsParams,
    CalsParams,
    Ktensor,
    LineSearchMethod,
    UpdateMethod,
    cp_als,
    cp_batched_als,
    cp_cals,
    jk_cp_batched_als,
    jk_cp_cals,
    random_ktensor_host,
)
from cp_cals_tpu_torch.convert import ktensor_from_numpy
from cp_cals_tpu_torch.ktensor import to_tensor
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.solvers import graph_loop
from cp_cals_tpu_torch.solvers import iteration as piter
from cp_cals_tpu_torch.solvers.state import BIG_ERROR, init_state

TOL = 1e-10
MODES = (9, 8, 7)
METHODS = ("no_error_checking", "error_checking")


def make_problem(seed, ranks, modes=MODES, noise=1e-3, nonneg=False):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    factors = [np.abs(f) for f in kt.factors] if nonneg else kt.factors
    x = np.einsum("ir,jr,kr,r->ijk", *factors, np.abs(kt.lam) if nonneg else kt.lam)
    x = x + noise * rng.standard_normal(modes)
    x = np.abs(x) if nonneg else x
    return x, [random_ktensor_host(rng, modes, r, dtype=np.float64) for r in ranks]


def jkt(kt):
    return JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def ls_kw(method, **kw):
    return dict(line_search=True, line_search_method=LineSearchMethod(method), **kw)


def to_jax(kw):
    """The same settings for the JAX package (its enums, the twostep MTTKRP,
    dimension tree off)."""
    out = dict(kw, mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off")
    for k, v in kw.items():
        if k == "line_search_method":
            out[k] = jcfg.LineSearchMethod(v.value)
        if k == "update_method":
            out[k] = jcfg.UpdateMethod(v.value)
    return out


def dense(kt):
    return to_tensor(Ktensor(tuple(torch.as_tensor(np.asarray(f)) for f in kt.factors),
                             torch.as_tensor(np.asarray(kt.lam)))).numpy()


def assert_models_equal(res_p, rep_p, res_j, rep_j, tol=TOL):
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p, rep_j):
        assert mp.iters == mj.iters
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, atol=tol)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=tol)
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            np.testing.assert_allclose(np.asarray(fp), np.asarray(fj), atol=tol)


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
@pytest.mark.parametrize("method", METHODS)
def test_cals_line_search_matches_jax_and_als(method, epilogue):
    """Both methods through eviction and refill, at both epilogues, against
    JAX's CALS, and CALS against the port's own ALS."""
    x, queue = make_problem(2, (3, 4, 3, 4, 2))
    kw = dict(tol=1e-9, buffer_size=8, bucket_ranks=(4,), **ls_kw(method))
    res_p, rep_p = cp_cals(x, queue, CalsParams(epilogue=epilogue, **kw), device="cpu")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in queue], jcfg.CalsParams(**to_jax(kw)))
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)
    ap = AlsParams(tol=1e-9, **ls_kw(method))
    for kt0, kt_cals, m in zip(queue[:2], res_p, rep_p.models):
        kt_als, rep_als = cp_als(x, kt0, ap, device="cpu")
        assert rep_als.iters == m.iters
        np.testing.assert_allclose(dense(kt_cals), dense(kt_als), atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_cals_nnls_line_search_matches_jax(method):
    """NNLS with line search: a NEC revert restores the active sets with
    the factors, EC keeps the pre-extrapolation sets on accept."""
    x, queue = make_problem(5, (3, 3, 2, 4), nonneg=True)
    kw = dict(tol=1e-9, buffer_size=6, bucket_ranks=(4,), update_method=UpdateMethod.NNLS,
              line_search_interval=3, **ls_kw(method))
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), device="cpu")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in queue], jcfg.CalsParams(**to_jax(kw)))
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)
    for kt in res_p:
        assert min(float(f.min()) for f in kt.factors) >= 0.0


@pytest.mark.parametrize("method", METHODS)
def test_als_drivers_line_search_match_jax(method):
    x, queue = make_problem(6, (3, 3, 3))
    kw = dict(tol=1e-9, max_iterations=150, line_search_step=2.0, **ls_kw(method))
    kt_p, rp = cp_als(x, queue[0], AlsParams(**kw), device="cpu")
    kt_j, rj = jax_cp_als(jnp.asarray(x), jkt(queue[0]), jcfg.AlsParams(**to_jax(kw)))
    assert_models_equal([kt_p], [rp], [kt_j], [rj])
    res_p, reps_p = cp_batched_als(x, queue, AlsParams(**kw), device="cpu")
    res_j, reps_j = jax_cp_batched_als(jnp.asarray(x), [jkt(k) for k in queue], jcfg.AlsParams(**to_jax(kw)))
    assert_models_equal(res_p, reps_p, res_j, reps_j)


def test_mixed_tier_with_line_search_no_blind_eviction():
    """Every extrapolation lands on a decision check (interval = K = 5) with
    a large fixed step, so most regress and are reverted: the guard keeps a
    blindly extrapolated model from stopping. ALS and CALS equal JAX's, and
    no returned model carries BIG_ERROR or an error far above the
    per-iteration oracle's."""
    k = 5
    x, queue = make_problem(17, (3, 4, 3, 4))
    base = dict(tol=1e-8, max_iterations=300, line_search=True, line_search_interval=k,
                line_search_step=4.0)
    for kt0 in queue[:2]:
        kt_o, ro = cp_als(x, kt0, AlsParams(**base), device="cpu")
        kt_m, rm = cp_als(x, kt0, AlsParams(tol_check_interval=k, **base), device="cpu")
        kt_j, rj = jax_cp_als(jnp.asarray(x), jkt(kt0), jcfg.AlsParams(**to_jax(dict(base, tol_check_interval=k))))
        assert_models_equal([kt_m], [rm], [kt_j], [rj])
        assert rm.approx_error < ro.approx_error * 1.5 + 1e-6
    kw = dict(base, bucket_ranks=(4,), buffer_size=8, tol_check_interval=k)
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), device="cpu")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(q) for q in queue], jcfg.CalsParams(**to_jax(kw)))
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)
    for m in rep_p.models:
        assert m.approx_error < BIG_ERROR / 2 and m.fit > 0.5


def mttkrp_per_model(x3, u1, u2, precision, plain=fm.fused_mttkrp_plain):
    """One plain product per model (tests/test_torch_engine_loop.py)."""
    return torch.cat([plain(x3, u1[s : s + 1], u2[s : s + 1], precision) for s in range(u1.shape[0])])


@pytest.mark.parametrize("case", ["forced", "tol"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_loop_line_search_is_bit_identical_to_the_iter_loop(chunk, method, case, monkeypatch):
    """The snapshot, the backup and the counters ride with the freeze
    select and the refills; the candidate MTTKRP of ERROR_CHECKING runs
    every iteration and is selected."""
    monkeypatch.setattr(fm, "fused_mttkrp_plain", mttkrp_per_model)
    x, queue = make_problem(7, (1, 2, 3, 4, 2, 3, 1))
    kw = dict(max_iterations=14, force_max_iter=True) if case == "forced" else dict(tol=1e-9)
    base = CalsParams(buffer_size=8, bucket_ranks=(2, 4), line_search_interval=3, **ls_kw(method), **kw)
    ref, rep_ref = cp_cals(x, queue, dataclasses.replace(base, sync_mode="iter"), device="cpu")
    monkeypatch.setattr(graph_loop, "chunk_length", lambda *a: chunk)
    got, rep_got = cp_cals(x, queue, base, device="cpu")
    for a, b, ma, mb in zip(ref, got, rep_ref.models, rep_got.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


def test_polish_turns_the_line_search_off():
    """Polish sweeps keep update_method and run without the line search, as
    in the JAX program: a polished NEC run equals JAX's."""
    x, queue = make_problem(8, (2, 3, 4, 3))
    kw = dict(tol=1e-7, buffer_size=8, bucket_ranks=(4,), polish_iters=3, **ls_kw("no_error_checking"))
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), device="cpu")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in queue], jcfg.CalsParams(**to_jax(kw)))
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)


@pytest.mark.parametrize("method", METHODS)
def test_jk_line_search_matches_jax_and_subsampled_als(method):
    """The masked-fiber CALS run with line search equals JAX's jackknife
    and the subsampled-tensor ALS oracle (ERROR_CHECKING's accept test uses
    the leave-one-out norm)."""
    rng = np.random.default_rng(7)
    modes = (6, 7, 5)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(modes)
    kt_ref = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    kw = dict(max_iterations=13, force_max_iter=True, bucket_ranks=(4,), line_search_interval=5,
              **ls_kw(method))
    rep_p = jk_cp_cals(x, [kt_ref], CalsParams(**kw), device="cpu")
    rep_j = jjk.jk_cp_cals(jnp.asarray(x), [jkt(kt_ref)], jcfg.CalsParams(**to_jax(kw)))
    for kp, kj in zip(rep_p.results[0], rep_j.results[0]):
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            fp, fj = np.asarray(fp), np.asarray(fj)
            mask = np.isfinite(fp)
            np.testing.assert_array_equal(mask, np.isfinite(fj))
            np.testing.assert_allclose(fp[mask], fj[mask], atol=1e-9)
    # The engine's replicate of a fiber against ALS on the subsampled tensor.
    ap = AlsParams(max_iterations=13, force_max_iter=True, line_search_interval=5, **ls_kw(method))
    for fiber in (0, modes[0] - 1):
        res, _ = cp_cals(x, [kt_ref], CalsParams(**kw), jk_fibers=[fiber], device="cpu")
        f0 = np.delete(kt_ref.factors[0], fiber, axis=0)
        kt_sub, _ = cp_als(np.delete(x, fiber, axis=0), Ktensor((f0,) + kt_ref.factors[1:], kt_ref.lam), ap,
                           device="cpu")
        jk_model = Ktensor((np.delete(res[0].factors[0], fiber, axis=0),) + res[0].factors[1:], res[0].lam)
        np.testing.assert_allclose(dense(jk_model), dense(kt_sub), atol=1e-10)
    # jk_cp_batched_als carries the line-search and NNLS fields.
    rep_b = jk_cp_batched_als(x, [kt_ref], AlsParams(max_iterations=13, force_max_iter=True,
                                                      line_search_interval=5, **ls_kw(method)), device="cpu")
    for kb, kp in zip(rep_b.results[0], rep_p.results[0]):
        for fb, fp in zip(kb.factors, kp.factors):
            mask = np.isfinite(fp)
            np.testing.assert_allclose(fb[mask], fp[mask], atol=1e-9)


# ------------------------------------------------------------ debug hook


@pytest.fixture
def clean_records():
    piter.MONOTONICITY_VIOLATIONS.clear()
    jiter.MONOTONICITY_VIOLATIONS.clear()
    yield
    piter.MONOTONICITY_VIOLATIONS.clear()
    jiter.MONOTONICITY_VIOLATIONS.clear()


def assert_entries_equal(got, want):
    assert len(got) == len(want) and got
    for (ip, op, np_), (ij, oj, nj) in zip(got, want):
        assert ip == ij
        np.testing.assert_allclose([op, np_], [oj, nj], rtol=1e-12, atol=1e-12)


def test_debug_hook_flags_an_error_increase(clean_records):
    """``test_monotonicity_debug_warning``: an artificially tiny previous
    error triggers the hook with JAX's entries; a normal fit records
    nothing."""
    x, queue = make_problem(21, (3, 3))
    xn = float(np.linalg.norm(x))
    kt_b = Ktensor(tuple(np.stack([q.factors[n] for q in queue]) for n in range(3)),
                   np.stack([q.lam for q in queue]))
    sp = init_state(ktensor_from_numpy(kt_b, "cpu"), xn)
    sp = sp._replace(iters=torch.full((2,), 5, dtype=torch.int32), approx_error=torch.zeros(2, dtype=torch.float64))
    sj = jax_init_state(jkt(kt_b), jnp.asarray(xn))
    sj = sj._replace(iters=jnp.full((2,), 5, jnp.int32), approx_error=jnp.zeros(2))
    pit = piter.make_iteration(CalsParams(debug=True))
    jit = jiter.make_iteration(jcfg.CalsParams(**to_jax(dict(debug=True))), batched=True)
    with pytest.warns(UserWarning, match="error increased"):
        pit(torch.from_numpy(x), sp, xn)
    with pytest.warns(UserWarning, match="error increased"):
        jax.block_until_ready(jit(jnp.asarray(x), sj, xn, jit.prepare(jnp.asarray(x))).fit)
    assert_entries_equal(piter.MONOTONICITY_VIOLATIONS, jiter.MONOTONICITY_VIOLATIONS)
    it, old_err, new_err = piter.MONOTONICITY_VIOLATIONS[0]
    assert it == 6 and new_err > old_err + 1e-4
    piter.MONOTONICITY_VIOLATIONS.clear()
    cp_als(x, queue[0], AlsParams(debug=True, tol=1e-9), device="cpu")
    assert not piter.MONOTONICITY_VIOLATIONS


def test_debug_hook_entries_equal_jax_in_an_engine_run(clean_records, monkeypatch):
    """An engine run through eviction and refill (one bucket: JAX runs
    buckets on threads) whose every model's weights are scaled by 1.05 on
    its 6th iteration, in both packages, so its error may rise there: the
    port's entries are JAX's, in order; without the bump it records
    nothing."""
    from cp_cals_tpu.solvers import cals as jcals

    x, queue = make_problem(17, (3, 4, 3, 4, 2))
    kw = dict(tol=1e-9, max_iterations=40, bucket_ranks=(4,), buffer_size=8, debug=True,
              line_search_interval=4, **ls_kw("no_error_checking"))
    res_p0, rep_p0 = cp_cals(x, queue, CalsParams(epilogue="xla", **kw), device="cpu")
    assert not piter.MONOTONICITY_VIOLATIONS

    def bump(orig, where):
        def bumped(u, iters, *args):
            f, lam, gm = orig(u, iters, *args)
            return f, where((iters == 6)[..., None], lam * 1.05, lam), gm
        return bumped

    monkeypatch.setattr(jiter, "normalize_factor_fused", bump(jiter.normalize_factor_fused, jnp.where))
    monkeypatch.setattr(piter, "normalize_factor_fused", bump(piter.normalize_factor_fused, torch.where))
    try:
        with pytest.warns(UserWarning, match="error increased"):
            res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(q) for q in queue], jcfg.CalsParams(**to_jax(kw)))
    finally:  # the bumped programs stay out of the JAX engine's caches
        for fn in vars(jcals).values():
            if hasattr(fn, "cache_clear"):
                fn.cache_clear()
    with pytest.warns(UserWarning, match="error increased"):
        res_p, rep_p = cp_cals(x, queue, CalsParams(epilogue="xla", **kw), device="cpu")
    assert_entries_equal(piter.MONOTONICITY_VIOLATIONS, list(jiter.MONOTONICITY_VIOLATIONS))
    assert {e[0] for e in piter.MONOTONICITY_VIOLATIONS} == {6}
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)


def test_chunk_policy_under_nec_line_search():
    """A revert holds a count at its check for one more iteration, so from a
    check the next chunk is one iteration under NO_ERROR_CHECKING; error
    checking never stalls a count."""
    live = np.array([True, True])
    nec = CalsParams(max_iterations=100, tol_check_interval=5, **ls_kw("no_error_checking"))
    ec = dataclasses.replace(nec, line_search_method=LineSearchMethod.ERROR_CHECKING)
    assert graph_loop.chunk_length(nec, np.array([15, 3]), live) == 1
    assert graph_loop.chunk_length(ec, np.array([15, 3]), live) == 4
    assert graph_loop.chunk_length(nec, np.array([14, 3]), live) == 1
    assert graph_loop.chunk_length(nec, np.array([11, 3]), live) == 3
