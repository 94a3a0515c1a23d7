"""The port's NNLS update (``ops/update.py:update_factor_nnls``) and the
engine under ``update_method=NNLS``, against the JAX package on the CPU in
float64.

- ``update_factor_nnls``, block principal pivoting and Lawson-Hanson, cold
  and warm active sets, a Cholesky failure and padded columns: factors at
  1e-10, active sets equal; in float32 on near-collinear normal matrices,
  the same rows left unconverged at the trip bounds as JAX's.
- The JAX package's NNLS tests (tests/test_nnls.py) on the port: brute
  force at 1e-8, BPP against Lawson-Hanson, warm-start consistency.
- ``cp_cals``, ``cp_als`` and ``cp_batched_als`` with NNLS (both
  algorithms, mixed-tier stopping, a 4-D tensor) against JAX at 1e-10;
  CALS against the port's own ALS; the chunked loop against the iter loop
  bit for bit; the JAX state carried over with its active sets.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.ops.update import _masked_solve as jax_masked_solve
from cp_cals_tpu.ops.update import padded_hadamard as jax_padded_hadamard
from cp_cals_tpu.ops.update import update_factor_nnls as jax_nnls
from cp_cals_tpu.solvers.als import cp_als as jax_cp_als
from cp_cals_tpu.solvers.als import cp_batched_als as jax_cp_batched_als
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu.solvers.iteration import make_iteration as jax_make_iteration
from cp_cals_tpu.solvers.state import init_state as jax_init_state
from cp_cals_tpu_torch import (
    AlsParams,
    CalsParams,
    Ktensor,
    UpdateMethod,
    cp_als,
    cp_batched_als,
    cp_cals,
    random_ktensor_host,
)
from cp_cals_tpu_torch.convert import ktensor_from_numpy, state_from_numpy
from cp_cals_tpu_torch.ktensor import to_tensor
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops.update import _masked_solve, padded_hadamard, update_factor_nnls
from cp_cals_tpu_torch.solvers import graph_loop
from cp_cals_tpu_torch.solvers.iteration import make_iteration
from cp_cals_tpu_torch.solvers.state import init_state

TOL = 1e-10
MODES = (9, 8, 7)
NNLS = UpdateMethod.NNLS
ALGORITHMS = ("bpp", "lawson_hanson")


def make_spd(rng, r, cond=10.0):
    a = rng.normal(size=(r, r))
    return a @ a.T + np.eye(r) / cond


def nonneg_problem(seed, ranks, modes=MODES, noise=1e-3):
    """A non-negative rank-3 target with noise (kept >= 0), and a queue of
    random inits, all made with numpy."""
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    letters = "ijkl"[: len(modes)]
    expr = ",".join(f"{c}r" for c in letters) + ",r->" + letters
    x = np.einsum(expr, *[np.abs(f) for f in kt.factors], np.abs(kt.lam))
    x = np.abs(x + noise * rng.standard_normal(modes))
    return x, [random_ktensor_host(rng, modes, r, dtype=np.float64) for r in ranks]


def jkt(kt):
    return JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def jax_cals_params(**kw):
    return jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", **kw)


def dense(kt):
    return to_tensor(Ktensor(tuple(torch.as_tensor(np.asarray(f)) for f in kt.factors),
                             torch.as_tensor(np.asarray(kt.lam)))).numpy()


def assert_models_equal(res_p, rep_p, res_j, rep_j, tol=TOL):
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p, rep_j):
        assert mp.iters == mj.iters
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, atol=tol)
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            np.testing.assert_allclose(np.asarray(fp), np.asarray(fj), atol=tol)
        assert min(float(np.min(f)) for f in kp.factors) >= 0.0


# ------------------------------------------------------------- the update


def update_case(case, seed=0):
    """(g, h, warm) of a small batch: 3 models x 7 rows x rank 6."""
    rng = np.random.default_rng(seed)
    b, i, r = 3, 7, 6
    h = np.stack([make_spd(rng, r) for _ in range(b)])
    g = rng.normal(size=(b, i, r))
    if case == "chol_failure":
        # Model 1 is indefinite: every passive set holding entry 2 fails.
        h[1] = np.diag([2.0, 1.5, -1.0, 3.0, 1.0, 2.5]) + 0.01
        g[1] = np.abs(g[1])
    if case == "padded":
        mask = np.arange(r) < np.array([[4], [6], [2]])
        g = g * mask[:, None, :]
        h = np.array(jax_padded_hadamard(jnp.asarray(h), jnp.asarray(mask)))
        np.testing.assert_array_equal(h, padded_hadamard(torch.from_numpy(h), torch.from_numpy(mask)).numpy())
    return g, h


@pytest.mark.parametrize("case", ["spd", "chol_failure", "padded"])
@pytest.mark.parametrize("warm", ["cold", "warm"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_update_factor_nnls_matches_jax(algorithm, warm, case):
    g, h = update_case(case)
    rng = np.random.default_rng(1)
    act = np.ones(g.shape, bool) if warm == "cold" else rng.random(g.shape) < 0.5
    d_j, a_j = jax_nnls(jnp.asarray(g), jnp.asarray(h), jnp.asarray(act), algorithm=algorithm)
    d_p, a_p = update_factor_nnls(torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(act),
                                  algorithm=algorithm)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), atol=TOL)
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    assert d_p.numpy().min() >= 0.0
    if case == "chol_failure":
        # The indefinite model's all-passive subsystem fails in both packages
        # and falls back to the zero row.
        passive = np.ones(g.shape[1:], bool)
        d_f, failed = _masked_solve(torch.from_numpy(h[1:2, None]), torch.from_numpy(g[1:2]),
                                    torch.from_numpy(passive[None]))
        dj_f, failed_j = jax.vmap(lambda y, p: jax_masked_solve(jnp.asarray(h[1]), y, p))(
            jnp.asarray(g[1]), jnp.asarray(passive))
        assert failed.all() and np.asarray(failed_j).all()
        assert not d_f.numpy().any() and not np.asarray(dj_f).any()
    if case == "padded":
        assert not d_p.numpy()[0, :, 4:].any() and not d_p.numpy()[2, :, 2:].any()
    # A warm start from the solution reproduces it.
    d2, _ = update_factor_nnls(torch.from_numpy(g), torch.from_numpy(h), a_p, algorithm=algorithm)
    np.testing.assert_allclose(d2.numpy(), d_p.numpy(), atol=TOL)


@pytest.mark.parametrize("max_outer", [1, 3])
def test_update_factor_nnls_bounded_outer_matches_jax(max_outer):
    """A small ``nnls_max_outer`` cuts both algorithms where JAX's does."""
    g, h = update_case("spd", seed=4)
    act = np.ones(g.shape, bool)
    for algorithm in ALGORITHMS:
        d_j, a_j = jax_nnls(jnp.asarray(g), jnp.asarray(h), jnp.asarray(act), max_outer, algorithm)
        d_p, a_p = update_factor_nnls(torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(act),
                                      max_outer, algorithm)
        np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), atol=TOL)
        np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))


def test_update_factor_nnls_rejects_an_unknown_algorithm():
    g, h = update_case("spd")
    with pytest.raises(ValueError, match="nnls_algorithm"):
        update_factor_nnls(torch.from_numpy(g), torch.from_numpy(h), torch.ones(g.shape, dtype=torch.bool),
                           algorithm="active_set")
    x, queue = nonneg_problem(0, (2,))
    with pytest.raises(ValueError, match="nnls_algorithm"):
        cp_cals(x, queue, CalsParams(update_method=NNLS, nnls_algorithm="pgd"), device="cpu")


def unconverged_rows(g, h, d, active):
    """Rows whose result breaks the solver's stopping conditions (an active
    entry of gradient above tol, a passive entry below -tol): ended at a
    trip bound."""
    tol = (10 * np.finfo(h.dtype).eps * np.abs(h).sum(-2).max(-1) * h.shape[-1])[:, None, None]
    w = g - d @ h
    return ((active & (w > tol)) | (~active & (d < -tol))).any(-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_float32_unconverged_rows_match_jax(algorithm, seed):
    """In float32, on normal matrices of near-collinear columns (condition
    2e6-7e6, as over-factored models give), Lawson-Hanson ends some rows
    at its trip bounds, unconverged, and BPP none; the port leaves the same
    rows as JAX's own float32 solver, with the same active sets, and the
    factors agree to float32 rounding (1e-5 of the largest entry)."""
    rng = np.random.default_rng(seed)
    b, i, r, k, n = 4, 64, 8, 5, 60
    a = np.abs(rng.standard_normal((b, n, k))) @ np.abs(rng.standard_normal((b, k, r)))
    a = a + 1e-2 * np.abs(rng.standard_normal((b, n, r)))
    h = np.einsum("bnr,bns->brs", a, a).astype(np.float32)
    g = np.einsum("bnr,bni->bir", a, np.abs(rng.standard_normal((b, n, i))))
    g = (g - 0.3 * h.mean() * rng.standard_normal((b, i, r))).astype(np.float32)
    warm = rng.random((b, i, r)) < 0.5
    d_j, a_j = jax_nnls(jnp.asarray(g), jnp.asarray(h), jnp.asarray(warm), 0, algorithm)
    d_p, a_p = update_factor_nnls(torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(warm), 0, algorithm)
    d_j, a_j, d_p, a_p = np.asarray(d_j), np.asarray(a_j), d_p.numpy(), a_p.numpy()
    left = unconverged_rows(g, h, d_p, a_p)
    np.testing.assert_array_equal(left, unconverged_rows(g, h, d_j, a_j))
    assert left.any() if algorithm == "lawson_hanson" else not left.any()
    np.testing.assert_array_equal(a_p, a_j)
    np.testing.assert_allclose(d_p, d_j, rtol=0, atol=1e-5 * np.abs(d_j).max())


# ------------------------------------- the JAX package's NNLS tests, ported


def brute_force_nnls(h, y):
    """Enumerate active sets; the feasible KKT point."""
    r = len(y)
    for mask in itertools.product([False, True], repeat=r):
        passive = np.array(mask)
        d = np.zeros(r)
        if passive.any():
            d[passive] = np.linalg.solve(h[np.ix_(passive, passive)], y[passive])
        if (d < -1e-9).any():
            continue
        w = y - h @ d
        if (~passive).any() and (w[~passive] > 1e-9).any():
            continue
        return d
    raise AssertionError("no KKT point")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_nnls_matches_bruteforce(algorithm):
    rng = np.random.default_rng(0)
    for trial in range(20):
        r = int(rng.integers(2, 6))
        h = make_spd(rng, r)
        y = rng.normal(size=r)
        d, _ = update_factor_nnls(torch.from_numpy(y)[None, None], torch.from_numpy(h)[None],
                                  torch.ones((1, 1, r), dtype=torch.bool), algorithm=algorithm)
        np.testing.assert_allclose(d.numpy()[0, 0], brute_force_nnls(h, y), atol=1e-8,
                                   err_msg=f"trial {trial}")


def test_bpp_equals_lawson_hanson_batched():
    rng = np.random.default_rng(1)
    b, i, r = 4, 6, 5
    h = torch.from_numpy(np.stack([make_spd(rng, r) for _ in range(b)]))
    g = torch.from_numpy(rng.normal(size=(b, i, r)))
    warm = torch.ones((b, i, r), dtype=torch.bool)
    d1, _ = update_factor_nnls(g, h, warm, algorithm="bpp")
    d2, _ = update_factor_nnls(g, h, warm, algorithm="lawson_hanson")
    assert float(d1.min()) >= 0.0
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=1e-8)


def test_nnls_warm_start_consistency():
    rng = np.random.default_rng(2)
    r = 5
    h = torch.from_numpy(make_spd(rng, r))[None]
    y = torch.from_numpy(rng.normal(size=r))[None, None]
    d1, act = update_factor_nnls(y, h, torch.ones((1, 1, r), dtype=torch.bool))
    d2, _ = update_factor_nnls(y, h, act)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=1e-10)


# ------------------------------------------------------------- the engine


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_cals_nnls_matches_jax_and_als(algorithm):
    """``test_cals_nnls_equals_als``: CALS through eviction and refill
    against JAX's CALS and the port's own ALS, factors >= 0."""
    x, queue = nonneg_problem(3, (3, 3, 2, 4, 3))
    kw = dict(tol=1e-8, buffer_size=6, bucket_ranks=(4,), update_method=NNLS, nnls_algorithm=algorithm)
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), device="cpu")
    jkw = dict(kw, update_method=jcfg.UpdateMethod.NNLS)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in queue], jax_cals_params(**jkw))
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)
    ap = AlsParams(tol=1e-8, update_method=NNLS, nnls_algorithm=algorithm)
    for kt0, kt_cals, m in zip(queue, res_p, rep_p.models):
        kt_als, rep_als = cp_als(x, kt0, ap, device="cpu")
        assert rep_als.iters == m.iters
        np.testing.assert_allclose(dense(kt_cals), dense(kt_als), atol=1e-9)


@pytest.mark.parametrize("epilogue", ["fused", "auto"])
def test_nnls_ignores_the_fused_epilogue(epilogue):
    """NNLS takes the unfused path whatever ``epilogue`` says, silently, as
    in JAX (an explicit "fused" with a non-GJ solve does not raise)."""
    x, queue = nonneg_problem(4, (2, 3))
    base = dict(max_iterations=6, force_max_iter=True, bucket_ranks=(4,), update_method=NNLS)
    ref, rep_ref = cp_cals(x, queue, CalsParams(epilogue="xla", **base), device="cpu")
    for solve in ("gj", "chol"):
        got, rep_got = cp_cals(x, queue, CalsParams(epilogue=epilogue, solve_method=solve, **base), device="cpu")
        for a, b in zip(ref, got):
            for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
                np.testing.assert_array_equal(fa, fb)


def test_cp_als_and_batched_als_nnls_match_jax():
    """NNLS through the ALS drivers, with mixed-tier stopping
    (``test_mixed_tier_tol_stopping_nnls``: the check reads the same tier,
    and stops where JAX's does)."""
    x, queue = nonneg_problem(31, (4, 4, 4))
    for k in (0, 5):
        ap = AlsParams(tol=1e-8, max_iterations=120, update_method=NNLS, tol_check_interval=k)
        jp = jcfg.AlsParams(tol=1e-8, max_iterations=120, update_method=jcfg.UpdateMethod.NNLS,
                            tol_check_interval=k, mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off")
        kt_p, rp = cp_als(x, queue[0], ap, device="cpu")
        kt_j, rj = jax_cp_als(jnp.asarray(x), jkt(queue[0]), jp)
        assert_models_equal([kt_p], [rp], [kt_j], [rj])
    ap = AlsParams(tol=1e-8, max_iterations=60, update_method=NNLS, nnls_algorithm="lawson_hanson")
    jp = jcfg.AlsParams(tol=1e-8, max_iterations=60, update_method=jcfg.UpdateMethod.NNLS,
                        nnls_algorithm="lawson_hanson", mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off")
    res_p, reps_p = cp_batched_als(x, queue, ap, device="cpu")
    res_j, reps_j = jax_cp_batched_als(jnp.asarray(x), [jkt(k) for k in queue], jp)
    assert_models_equal(res_p, reps_p, res_j, reps_j)


def test_cals_nnls_4d_matches_jax():
    modes = (6, 5, 4, 3)
    x, queue = nonneg_problem(8, (2, 3, 2), modes=modes)
    kw = dict(tol=1e-8, max_iterations=40, buffer_size=8, bucket_ranks=(4,), update_method=NNLS)
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw), device="cpu")
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in queue],
                               jax_cals_params(**dict(kw, update_method=jcfg.UpdateMethod.NNLS)))
    assert_models_equal(res_p, rep_p.models, res_j, rep_j.models)


def mttkrp_per_model(x3, u1, u2, precision, plain=fm.fused_mttkrp_plain):
    """One plain product per model: a model's bits do not depend on its
    slot (tests/test_torch_engine_loop.py)."""
    return torch.cat([plain(x3, u1[s : s + 1], u2[s : s + 1], precision) for s in range(u1.shape[0])])


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_loop_nnls_is_bit_identical_to_the_iter_loop(chunk, algorithm, monkeypatch):
    """The frozen models' active sets ride with the freeze select and the
    refills write fresh all-active sets."""
    monkeypatch.setattr(fm, "fused_mttkrp_plain", mttkrp_per_model)
    x, queue = nonneg_problem(5, (1, 2, 3, 4, 2, 3, 1))
    base = CalsParams(tol=1e-9, buffer_size=8, bucket_ranks=(2, 4), update_method=NNLS,
                      nnls_algorithm=algorithm)
    ref, rep_ref = cp_cals(x, queue, dataclasses.replace(base, sync_mode="iter"), device="cpu")
    monkeypatch.setattr(graph_loop, "chunk_length", lambda *a: chunk)
    got, rep_got = cp_cals(x, queue, base, device="cpu")
    for a, b, ma, mb in zip(ref, got, rep_ref.models, rep_got.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


def test_state_from_numpy_carries_nnls_and_line_search():
    """A JAX state with active sets and an LsState (backup active sets
    included), two iterations in, carried into the port: one more
    iteration each gives the same model, active sets and carry."""
    x, queue = nonneg_problem(9, (3, 3))
    b, r = 2, 4
    factors = [np.zeros((b, m, r)) for m in MODES]
    lam = np.zeros((b, r))
    for s, kt in enumerate(queue):
        for f_dst, f_src in zip(factors, kt.factors):
            f_dst[s, :, :3] = f_src
        lam[s, :3] = kt.lam
    mask = np.broadcast_to(np.arange(r) < 3, (b, r)).copy()
    xn = float(np.linalg.norm(x))
    kw = dict(update_method=jcfg.UpdateMethod.NNLS, line_search=True, line_search_interval=2,
              force_max_iter=True)
    jit = jax_make_iteration(jax_cals_params(**kw), batched=True)
    xj = jnp.asarray(x)
    sj = jax_init_state(JKtensor(tuple(jnp.asarray(f) for f in factors), jnp.asarray(lam)), jnp.asarray(xn),
                        nnls=True, line_search=True, rank_mask=jnp.asarray(mask))
    for _ in range(3):
        sj = jit(xj, sj, xn, jit.prepare(xj))
    sj_np = jax.tree.map(np.asarray, sj)
    carried = state_from_numpy(sj_np, "cpu")
    assert len(carried.active) == 3 and carried.active[0].dtype == torch.bool
    assert len(carried.ls.backup_active) == 3
    pit = make_iteration(CalsParams(update_method=NNLS, line_search=True, line_search_interval=2,
                                    force_max_iter=True))
    xt = torch.from_numpy(x)
    sp = pit(xt, carried, xn, pit.prepare(xt))
    sj2 = jax.tree.map(np.asarray, jit(xj, sj, xn, jit.prepare(xj)))
    for a, w in zip(sp.kt.factors + (sp.kt.lam,), sj2.kt.factors + (sj2.kt.lam,)):
        np.testing.assert_allclose(a.numpy(), w, atol=TOL)
    for a, w in zip(sp.active + sp.ls.backup_active, sj2.active + sj2.ls.backup_active):
        np.testing.assert_array_equal(a.numpy(), w)
    np.testing.assert_array_equal(sp.ls.it.numpy(), sj2.ls.it)
    np.testing.assert_array_equal(sp.ls.updated_last.numpy(), sj2.ls.updated_last)
    for a, w in zip(sp.ls.prev.factors, sj2.ls.prev.factors):
        np.testing.assert_allclose(a.numpy(), w, atol=TOL)
    # A fresh port state has JAX's initial carries.
    fresh = init_state(ktensor_from_numpy(Ktensor(factors, lam), "cpu"), xn, nnls=True, line_search=True)
    assert all(a.all() for a in fresh.active) and not fresh.ls.updated_last.any()
    assert fresh.ls.prev is fresh.kt and fresh.ls.backup_active is fresh.active
