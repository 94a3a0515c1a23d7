"""N-D tensors and every MTTKRP method and layout policy through the port's
entry points, against the JAX package, on the CPU.

fp64 (the algorithm), from the same explicit inits, with the MTTKRP method
and ``dimtree`` set explicitly in both packages: ``cp_cals`` on a 4-D
problem and on the 5-D problem of tests/test_cals.py's
``test_cals_5d_equals_als``, the dimension tree on 3-D, the mixed-tier
check and polish on 4-D, ``cp_als`` on 4-D and ``jk_cp_cals`` on a small
4-D tensor: factors and fits at 1e-10, iteration counts equal. In the port
alone: CALS == ALS on 5-D, ``mode_layouts="recompute"`` equal to
``"materialized"`` bit for bit, and the MTTKRP routes each run takes. The
fused epilogue's plain versions with K = 3 and 4 other-mode gramians (4-D
and 5-D) against JAX's Pallas kernels in interpret mode, at the JAX
suite's epilogue band (2e-4 in float32) and 1e-11 in float64; the error
against JAX's ``fast_error_from_cols`` on the apply's columns with all N
gramians.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
import cp_cals_tpu.solvers.jackknife as jjk
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.ops.error import fast_error_from_cols as jax_fast_error_from_cols
from cp_cals_tpu.ops.pallas_epilogue import epilogue_apply_pallas, normal_inverse_pallas
from cp_cals_tpu.solvers.als import cp_als as jax_cp_als
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu_torch import (
    AlsParams,
    CalsParams,
    Ktensor,
    MttkrpMethod,
    cp_als,
    cp_cals,
    jk_cp_cals,
    launches,
    random_ktensor_host,
)
from cp_cals_tpu_torch.convert import ktensor_from_numpy, state_from_numpy
from cp_cals_tpu_torch.ktensor import to_tensor
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops.gramians import gramians
from cp_cals_tpu_torch.solvers.iteration import make_iteration

TOL = 1e-10
MODES4 = (6, 5, 4, 3)
MODES5 = (5, 4, 3, 3, 2)


def make_problem(modes, seed, ranks, rank_x=2, noise=1e-3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, modes, rank_x, dtype=dtype)
    x = np.asarray(to_tensor(Ktensor(tuple(torch.from_numpy(f) for f in kt.factors), torch.from_numpy(kt.lam))))
    x = (x + noise * rng.standard_normal(modes)).astype(dtype)
    return x, [random_ktensor_host(rng, modes, r, dtype=dtype) for r in ranks]


def jkt(kt):
    return JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def jax_method(method):
    return jcfg.MttkrpMethod({"auto": "twostep"}.get(method, method))


def assert_matches(res_p, rep_p, res_j, rep_j, tol=TOL):
    assert len(res_p) == len(res_j)
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert (mp.id, mp.rank, mp.iters) == (mj.id, mj.rank, mj.iters)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=tol)
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, atol=tol, rtol=tol)
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            np.testing.assert_allclose(fp, np.asarray(fj), atol=tol, rtol=tol)


def assert_bit_identical(a, b):
    (res_a, rep_a), (res_b, rep_b) = a, b
    for ka, kb, ma, mb in zip(res_a, res_b, rep_a.models, rep_b.models):
        assert (ma.id, ma.iters, ma.fit, ma.approx_error) == (mb.id, mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(ka.factors + (ka.lam,), kb.factors + (kb.lam,)):
            np.testing.assert_array_equal(fa, fb)


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
@pytest.mark.parametrize("method", ["auto", "twostep", "krp_gemm"])
def test_cp_cals_4d_matches_jax(method, epilogue):
    """A 4-D queue through bucketing, eviction and refill (a parent PR
    raised NotImplementedError here); ``auto`` takes the twostep on every
    mode of an N-D tensor."""
    x, kts = make_problem(MODES4, 0, (1, 2, 3, 3, 2, 1))
    kw = dict(tol=1e-9, max_iterations=200, buffer_size=8, bucket_ranks=(2, 4))
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts],
                               jcfg.CalsParams(mttkrp_method=jax_method(method), dimtree="off", **kw))
    launches.reset()
    res_p, rep_p = cp_cals(x, kts, CalsParams(mttkrp_method=MttkrpMethod(method), dimtree="off",
                                              epilogue=epilogue, **kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    routes = launches.routes()
    want = {"auto": "twostep"}.get(method, method)
    assert routes[want] == 4 * sum(rep_p.engine_iterations.values())
    assert sum(routes.values()) == routes[want]


def test_cp_cals_5d_matches_jax_and_equals_als():
    """test_cals_5d_equals_als, in the port and against JAX: the same
    models from JAX's cp_cals, and each CALS model equal to its own
    cp_als run (iteration count and factors)."""
    x, kts = make_problem(MODES5, 17, (2,) * 5)
    kw = dict(tol=1e-9, buffer_size=4, bucket_ranks=(2,))
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts],
                               jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", **kw))
    res_p, rep_p = cp_cals(x, kts, CalsParams(mttkrp_method=MttkrpMethod.TWOSTEP, **kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    for kt0, kp, mp in zip(kts, res_p, rep_p.models):
        ka, ra = cp_als(x, kt0, AlsParams(tol=1e-9, mttkrp_method=MttkrpMethod.TWOSTEP), device="cpu")
        assert ra.iters == mp.iters
        for fa, fp in zip(ka.factors + (ka.lam,), kp.factors + (kp.lam,)):
            np.testing.assert_allclose(fa, fp, atol=1e-11)


@pytest.mark.parametrize("method", ["twostep", "krp_gemm"])
def test_cp_als_4d_matches_jax(method):
    x, (kt0,) = make_problem(MODES4, 3, (3,))
    p = dict(tol=1e-10, max_iterations=300, mttkrp_method=method, dimtree="off")
    kt_j, r_j = jax_cp_als(jnp.asarray(x), jkt(kt0), jcfg.AlsParams(**{**p, "mttkrp_method": jax_method(method)}))
    kt_p, r_p = cp_als(x, kt0, AlsParams(**{**p, "mttkrp_method": MttkrpMethod(method)}), device="cpu")
    assert (r_p.iters, r_p.converged) == (r_j.iters, r_j.converged)
    np.testing.assert_allclose(r_p.fit, r_j.fit, atol=TOL)
    for fp, fj in zip(kt_p.factors + (kt_p.lam,), kt_j.factors + (kt_j.lam,)):
        np.testing.assert_allclose(fp, np.asarray(fj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("method", ["pallas", "twostep"])
def test_dimtree_on_matches_jax(method):
    """dimtree="on" (3-D): modes 1 and 2 from the shared TTM, against JAX's
    dimension-tree sweep; mode 0 by ``method`` (the fused kernels' plain
    version here against JAX's twostep)."""
    modes = (9, 8, 7)
    x, kts = make_problem(modes, 5, (2, 3, 4, 2))
    kw = dict(tol=1e-9, max_iterations=200, buffer_size=12, bucket_ranks=(2, 4))
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts],
                               jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="on", **kw))
    launches.reset()
    res_p, rep_p = cp_cals(x, kts, CalsParams(mttkrp_method=MttkrpMethod(method), dimtree="on", **kw),
                           device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    steps = sum(rep_p.engine_iterations.values())
    routes = launches.routes()
    assert routes["dimtree"] == 2 * steps
    assert routes["fused" if method == "pallas" else "twostep"] == steps


@pytest.mark.parametrize("case", ["4d", "dimtree", "mixed-tier-polish"])
def test_recompute_equals_materialized(case):
    """mode_layouts="recompute" derives every layout inside the iteration
    and gives the held layouts' bits."""
    if case == "4d":
        x, kts = make_problem(MODES4, 1, (2, 3, 1))
        kw = dict(mttkrp_method=MttkrpMethod.TWOSTEP)
    elif case == "dimtree":
        x, kts = make_problem((9, 8, 7), 2, (2, 3, 1))
        kw = dict(dimtree="on")
    else:
        x, kts = make_problem(MODES4, 4, (2, 3, 1), dtype=np.float32, noise=1e-2)
        kw = dict(precision="highest", mttkrp_precision="default", tol_check_interval=3, polish_iters=2,
                  mttkrp_method=MttkrpMethod.PALLAS)
    common = dict(tol=1e-8, max_iterations=60, buffer_size=8, bucket_ranks=(2, 4), **kw)
    runs = [cp_cals(x, kts, CalsParams(mode_layouts=lay, **common), device="cpu")
            for lay in ("materialized", "recompute")]
    assert_bit_identical(*runs)
    held = make_iteration(CalsParams(mode_layouts="recompute", **kw)).prepare(torch.from_numpy(x))
    assert all(h is None for h in held)
    auto = make_iteration(CalsParams(**kw)).prepare(torch.from_numpy(x))
    assert all(h is not None for h in auto)  # "auto": a small tensor holds its layouts


def test_auto_layouts_recompute_above_128_mb():
    from cp_cals_tpu_torch.config import resolve_layouts

    assert resolve_layouts(CalsParams(), torch.zeros(4, 4, 4)) == "materialized"
    big = torch.empty((1025, 1024, 32), dtype=torch.float32)  # just above 128 MB
    assert resolve_layouts(CalsParams(), big) == "recompute"
    assert resolve_layouts(CalsParams(mode_layouts="materialized"), big) == "materialized"


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
def test_mixed_tier_and_polish_4d_match_jax(epilogue):
    """The mixed-tier check (its last-mode MTTKRP a twostep, run every
    iteration and selected) and polish sweeps on a 4-D queue."""
    x, kts = make_problem(MODES4, 7, (2, 3, 4, 2, 3))
    kw = dict(tol=1e-8, max_iterations=300, bucket_ranks=(4,), buffer_size=12, tol_check_interval=3,
              polish_iters=2)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts],
                               jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off",
                                               epilogue="xla", **kw))
    launches.reset()
    res_p, rep_p = cp_cals(x, kts, CalsParams(epilogue=epilogue, **kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)
    steps = sum(rep_p.engine_iterations.values())
    sweeps = sum(c["polish_sweeps"] for c in rep_p.loop_counts.values())
    # 4 modes per iteration and per sweep, and the check's every iteration
    assert launches.routes()["twostep"] == 4 * (steps + sweeps) + steps


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_mixed_tier_chunks_end_at_pre_checks(seed):
    """A model can stop at a pre-check (iteration mK-1), where JAX's loop
    evicts it and refills the slot. The parent's graph loop ran each chunk
    on to the oldest model's decision check mK, so the refill came an
    iteration late and later models' checks fell elsewhere (3-D, fp64; on
    these seeds one model's stop moved by one iteration)."""
    x, kts = make_problem((9, 8, 7), seed, (2, 3, 4, 2, 3))
    kw = dict(tol=1e-8, max_iterations=300, bucket_ranks=(4,), buffer_size=12, tol_check_interval=3)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [jkt(k) for k in kts],
                               jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off",
                                               epilogue="xla", **kw))
    res_p, rep_p = cp_cals(x, kts, CalsParams(**kw), device="cpu")
    assert_matches(res_p, rep_p, res_j, rep_j)


def test_jk_cp_cals_4d_matches_jax():
    x, (kt0,) = make_problem(MODES4, 9, (2,))
    kt_fit, _ = cp_als(x, kt0, AlsParams(tol=1e-10, max_iterations=300), device="cpu")
    kw = dict(tol=1e-8, max_iterations=100, buffer_size=8, bucket_ranks=(2,))
    rep_j = jjk.jk_cp_cals(jnp.asarray(x), [jkt(kt_fit)],
                           jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", **kw))
    rep_p = jk_cp_cals(x, [kt_fit], CalsParams(**kw), device="cpu")
    (reps_p,), (reps_j,) = rep_p.results, rep_j.results
    assert len(reps_p) == len(reps_j) == MODES4[0]
    for fiber, (ka, kb) in enumerate(zip(reps_p, reps_j)):
        assert np.isnan(ka.factors[0][fiber]).all()
        for fa, fb in zip(ka.factors + (ka.lam,), kb.factors + (kb.lam,)):
            fa, fb = np.asarray(fa), np.asarray(fb)
            mask = np.isfinite(fa)
            assert (mask == np.isfinite(fb)).all()
            np.testing.assert_allclose(fa[mask], fb[mask], atol=TOL)


def test_nd_state_carries_over_from_jax():
    """A 4-D JAX iteration state pulled to NumPy steps on in the port as in
    JAX (convert.py is rank-agnostic)."""
    from cp_cals_tpu.solvers.iteration import make_iteration as jax_make_iteration
    from cp_cals_tpu.solvers.state import init_state as jax_init_state

    x, kts = make_problem(MODES4, 12, (3, 3))
    kt_b = JKtensor(tuple(jnp.stack([jnp.asarray(k.factors[n]) for k in kts]) for n in range(4)),
                    jnp.stack([jnp.asarray(k.lam) for k in kts]))
    x_norm = jnp.linalg.norm(jnp.asarray(x))
    jp = jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off")
    j_iter = jax_make_iteration(jp, batched=True)
    s1 = j_iter(jnp.asarray(x), jax_init_state(kt_b, x_norm), x_norm)
    s2 = j_iter(jnp.asarray(x), s1, x_norm)
    import jax

    p_state = state_from_numpy(jax.tree.map(np.asarray, s1), device="cpu")
    p2 = make_iteration(CalsParams(mttkrp_method=MttkrpMethod.TWOSTEP, epilogue="xla"))(
        torch.from_numpy(x), p_state, torch.tensor(float(x_norm), dtype=torch.float64))
    for fp, fj in zip(p2.kt.factors, s2.kt.factors):
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=1e-11)
    np.testing.assert_allclose(p2.fit.numpy(), np.asarray(s2.fit), atol=1e-11)
    kt = ktensor_from_numpy(jax.tree.map(np.asarray, kts[0]), device="cpu")
    assert kt.n_modes == 4 and kt.modes == MODES4


# ------------------------------------------- the epilogue with K = 3, 4 gramians


def _epilogue_problem(modes, dtype, b=7, r=5, pad=3, seed=0):
    """Normalized factors with padded ranks and slot b-1 dead; G of the last
    mode; jackknife fibers on some slots; model norms."""
    rng = np.random.default_rng(seed)
    rr = r + pad
    mask = np.broadcast_to(np.arange(rr) < r, (b, rr)).copy()
    mask[-1] = False
    mask[1, r - 1] = False
    factors = []
    for m in modes:
        f = rng.normal(size=(b, m, rr)) * mask[:, None, :]
        factors.append((f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-30)).astype(dtype))
    g = (rng.normal(size=(b, modes[-1], rr)) * mask[:, None, :]).astype(dtype)
    jk = np.asarray([2, -1, 0, -1, 1, -1, 3], np.int32)[:b]
    x_norm = rng.uniform(8.0, 12.0, size=b).astype(dtype)
    return factors, mask, g, jk, x_norm


@pytest.mark.parametrize("modes", [MODES4, MODES5], ids=["K3", "K4"])
def test_normal_inverse_with_n_minus_1_gramians_matches_pallas(modes):
    """A parent PR's kernel took exactly two gramians (its wrapper raised);
    the plain version takes K = N - 1, as JAX's kernel does."""
    factors, mask, _, _, _ = _epilogue_problem(modes, np.float32, seed=len(modes))
    grams = gramians([torch.from_numpy(f) for f in factors])
    for skip in range(len(modes)):
        got = fe.normal_inverse(grams, torch.from_numpy(mask), skip)
        want = normal_inverse_pallas(tuple(jnp.asarray(g.numpy()) for g in grams), jnp.asarray(mask), skip,
                                     interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
        assert torch.equal(got, fe.normal_inverse_plain(grams, torch.from_numpy(mask), skip))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4), (np.float64, 1e-11)])
@pytest.mark.parametrize("zero_jk", [False, True])
@pytest.mark.parametrize("modes", [MODES4, MODES5], ids=["K3", "K4"])
def test_apply_with_n_minus_1_gramians_matches_pallas(modes, zero_jk, dtype, tol):
    factors, mask, g, jk, x_norm = _epilogue_problem(modes, dtype, seed=3 + zero_jk)
    b, n = g.shape[0], len(modes)
    grams = gramians([torch.from_numpy(f) for f in factors])
    hinv = fe.normal_inverse(grams, torch.from_numpy(mask), n - 1)
    iters = np.full((b,), 4, np.int32)
    err_inputs = (torch.from_numpy(x_norm), *grams[:-1])
    f, lam, gm, err = fe.epilogue_apply(torch.from_numpy(g), hinv, torch.from_numpy(iters),
                                        torch.from_numpy(jk), zero_jk, err_inputs)
    wf, wlam, wgm_raw, wt3 = epilogue_apply_pallas(
        jnp.asarray(g), jnp.asarray(hinv.numpy()), jnp.asarray(iters), jnp.asarray(jk),
        zero_jk=zero_jk, with_err=True, interpret=True,
    )
    safe = jnp.where(wlam != 0, wlam, 1.0)
    wgm = wgm_raw / (safe[..., :, None] * safe[..., None, :])
    for got, want in ((f, wf), (lam, wlam), (gm, wgm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    h = jnp.asarray(grams[0].numpy())  # all N gramians, in mode order
    for q in range(1, n - 1):
        h = h * jnp.asarray(grams[q].numpy())
    h = h * wgm
    want_err = jax_fast_error_from_cols(jnp.asarray(x_norm), wlam, wt3[0], wt3[1], h)
    np.testing.assert_allclose(err.numpy(), np.asarray(want_err), rtol=tol, atol=tol)
    np.testing.assert_allclose(err[-1].item(), x_norm[-1], rtol=tol)  # the dead slot: its norm


def test_fused_epilogue_gate_admits_3_to_8_modes():
    for n, want in ((2, True), (3, True), (5, True), (8, True), (9, True)):
        assert fe.supports_fused_epilogue(4, 10, 4, torch.float32, n, "cpu") is want  # the CPU takes all
    assert fe.MAX_MODES == 8
