"""The port's jackknife against the JAX package, on the CPU in float64.

The three port drivers against the three JAX drivers from the same fitted
model: factors compared where finite to 1e-9, with equal NaN masks (JAX
runs the twostep MTTKRP with the dimension tree off; "pallas" as "gj",
since its kernel cannot run inside its solvers on the CPU). Then the
reference's LogicCorrectness and FunctionCorrectness patterns
(tests/test_jackknife.py) on the port alone, the helpers, the LSAP solver
and the fidelity pin.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
import cp_cals_tpu.solvers.jackknife as jjk
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.utils.lsap import _solve_lsap_py
from cp_cals_tpu_torch import (
    AlsParams,
    CalsParams,
    Ktensor,
    cp_als,
    cp_cals,
    jackknife_norms,
    jk_cp_als,
    jk_cp_batched_als,
    jk_cp_cals,
    random_ktensor_host,
)
from cp_cals_tpu_torch.ktensor import to_tensor
from cp_cals_tpu_torch.solvers import jackknife as pjk
from cp_cals_tpu_torch.utils.lsap import solve_lsap

MODES = (6, 7, 5)


def make_problem(seed, rank=2):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, rank, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(MODES)
    kt0 = random_ktensor_host(rng, MODES, rank, dtype=np.float64)
    return x, kt0


def fitted_model(seed, rank=2):
    """A base model fitted by the port's cp_als (both drivers start from it)."""
    x, kt0 = make_problem(seed, rank)
    kt_fit, _ = cp_als(x, kt0, AlsParams(tol=1e-10, max_iterations=300), device="cpu")
    return x, kt_fit


def jkt(kt):
    return JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def assert_replicates_close(a, b, tol):
    assert len(a) == len(b) == MODES[0]
    for ka, kb in zip(a, b):
        for fa, fb in zip(ka.factors, kb.factors):
            fa, fb = np.asarray(fa), np.asarray(fb)
            mask = np.isfinite(fa)
            assert (mask == np.isfinite(fb)).all()
            np.testing.assert_allclose(fa[mask], fb[mask], atol=tol)
        np.testing.assert_allclose(np.asarray(ka.lam), np.asarray(kb.lam), atol=tol, rtol=tol)


def test_jackknife_norms():
    x = np.random.default_rng(0).normal(size=MODES)
    got = jackknife_norms(torch.from_numpy(x)).numpy()
    for i in range(MODES[0]):
        np.testing.assert_allclose(got[i], np.linalg.norm(np.delete(x, i, axis=0)), rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jjk.jackknife_norms(jnp.asarray(x))), rtol=1e-12)
    x32 = jackknife_norms(torch.from_numpy(x.astype(np.float32)))
    assert x32.dtype == torch.float32
    # One fiber holding all the energy: the difference clamps at 0, no NaN.
    spike = np.zeros(MODES)
    spike[2, 3, 1] = 1e20
    assert np.isfinite(jackknife_norms(torch.from_numpy(spike)).numpy()).all()


def test_lsap_small():
    cost = np.array([[4.0, 1.0, 3.0], [2.0, 0.0, 5.0], [3.0, 2.0, 2.0]])
    best = min(itertools.permutations(range(3)), key=lambda p: sum(cost[i, p[i]] for i in range(3)))
    assert tuple(solve_lsap(cost)) == best


@pytest.mark.parametrize("maximize", [False, True])
def test_lsap_matches_jax_and_brute_force(maximize):
    rng = np.random.default_rng(0)
    sign = -1 if maximize else 1
    for _ in range(20):
        n = int(rng.integers(2, 6))
        cost = rng.normal(size=(n, n))
        perm = solve_lsap(cost, maximize)
        np.testing.assert_array_equal(perm, _solve_lsap_py(cost, maximize))
        best = min(itertools.permutations(range(n)), key=lambda p: sign * sum(cost[i, p[i]] for i in range(n)))
        np.testing.assert_allclose(sum(cost[i, perm[i]] for i in range(n)),
                                   sum(cost[i, best[i]] for i in range(n)), atol=1e-12)
    for shape in [(3, 5), (5, 3)]:  # rectangular, both orientations
        cost = rng.normal(size=shape)
        np.testing.assert_array_equal(solve_lsap(cost, maximize), _solve_lsap_py(cost, maximize))


def test_host_helpers_match_jax():
    """to_host_model, generate_jk_ktensors, _rescale_replicate and
    jk_permutation_adjustment are host NumPy math in both packages."""
    rng = np.random.default_rng(3)
    kt = random_ktensor_host(rng, MODES, 3, dtype=np.float64)
    kt = Ktensor(kt.factors, kt.lam * np.array([2.0, -1.5, 0.5]))
    a, b = pjk.to_host_model(kt), jjk.to_host_model(jkt(kt))
    for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
        np.testing.assert_allclose(fa, np.asarray(fb), atol=1e-15)
    reps = pjk.generate_jk_ktensors(a)
    assert [f for _, f in reps] == list(range(MODES[0])) and all(k is a for k, _ in reps)
    with pytest.raises(ValueError, match="single sample"):
        pjk.generate_jk_ktensors(Ktensor((np.ones((1, 2)),) + a.factors[1:], a.lam[:2]))
    r_p, r_j = pjk._rescale_replicate(a, 2), jjk._rescale_replicate(a, 2)
    for fa, fb in zip(r_p.factors + (r_p.lam,), r_j.factors + (r_j.lam,)):
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
        np.testing.assert_allclose(fa[np.isfinite(fa)], fb[np.isfinite(fb)], atol=1e-15)
    assert np.isnan(r_p.factors[0][2]).all()
    perm = [2, 0, 1]
    shuffled = Ktensor(tuple(f[:, perm] for f in a.factors), a.lam[perm])
    (back,) = pjk.jk_permutation_adjustment(a, [shuffled])
    (back_j,) = jjk.jk_permutation_adjustment(a, [shuffled])
    for fa, fb, fj in zip(back.factors, a.factors, back_j.factors):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(fa, fj)


@pytest.mark.parametrize(
    "driver,solve",
    [("jk_cp_cals", "gj"), ("jk_cp_cals", "pallas"), ("jk_cp_batched_als", "pallas"),
     ("jk_cp_batched_als", "chol"), ("jk_cp_als", "gj")],
)
def test_drivers_match_jax(driver, solve):
    x, kt_fit = fitted_model(2)
    n_iter = 12
    jsolve = "gj" if solve == "pallas" else solve
    common = dict(max_iterations=n_iter, force_max_iter=True, mttkrp_method=jcfg.MttkrpMethod.TWOSTEP)
    if driver == "jk_cp_cals":
        got = jk_cp_cals(x, [kt_fit], CalsParams(max_iterations=n_iter, force_max_iter=True, bucket_ranks=(2,),
                                                  solve_method=solve), device="cpu")
        want = jjk.jk_cp_cals(jnp.asarray(x), [jkt(kt_fit)],
                              jcfg.CalsParams(bucket_ranks=(2,), solve_method=jsolve, **common))
        assert sum(got.cals_report.engine_iterations.values()) == n_iter
    else:
        port_fn, jax_fn = {"jk_cp_batched_als": (jk_cp_batched_als, jjk.jk_cp_batched_als),
                           "jk_cp_als": (jk_cp_als, jjk.jk_cp_als)}[driver]
        got = port_fn(x, [kt_fit], AlsParams(max_iterations=n_iter, force_max_iter=True, solve_method=solve),
                      device="cpu")
        want = jax_fn(jnp.asarray(x), [jkt(kt_fit)],
                      jcfg.AlsParams(solve_method=jsolve, dimtree="off", **common))
    assert len(got.results) == 1
    assert_replicates_close(got.results[0], want.results[0], 1e-9)


@pytest.mark.parametrize("fiber", [0, 2, MODES[0] - 1])
def test_masked_fiber_equals_subsampled_als(fiber):
    """LogicCorrectness: zeroed-fiber CALS on the full tensor == ALS on the
    explicitly subsampled tensor from the same init without the fiber row."""
    x, kt_ref = make_problem(1, rank=3)
    n_iter = 10
    params = CalsParams(max_iterations=n_iter, force_max_iter=True, bucket_ranks=(4,))
    (kt_jk,), _ = cp_cals(x, [kt_ref], params, jk_fibers=[fiber], device="cpu")
    f0 = np.delete(kt_ref.factors[0], fiber, axis=0)
    kt_sub, _ = cp_als(np.delete(x, fiber, axis=0), Ktensor((f0,) + kt_ref.factors[1:], kt_ref.lam),
                       AlsParams(max_iterations=n_iter, force_max_iter=True), device="cpu")
    reg = Ktensor((torch.from_numpy(np.delete(kt_jk.factors[0], fiber, axis=0)),)
                  + tuple(torch.from_numpy(f) for f in kt_jk.factors[1:]), torch.from_numpy(kt_jk.lam))
    sub = Ktensor(tuple(torch.from_numpy(f) for f in kt_sub.factors), torch.from_numpy(kt_sub.lam))
    np.testing.assert_allclose(to_tensor(reg).numpy(), to_tensor(sub).numpy(), atol=1e-10)


def test_function_correctness():
    """FunctionCorrectness: jk_cp_cals == jk_cp_als end to end, rescaling
    and LSAP adjustment included, and jk_cp_batched_als == jk_cp_cals."""
    x, kt_fit = fitted_model(5)
    n_iter = 15
    a = jk_cp_cals(x, [kt_fit], CalsParams(max_iterations=n_iter, force_max_iter=True, bucket_ranks=(2,)),
                   device="cpu")
    b = jk_cp_als(x, [kt_fit], AlsParams(max_iterations=n_iter, force_max_iter=True), device="cpu")
    c = jk_cp_batched_als(x, [kt_fit], AlsParams(max_iterations=n_iter, force_max_iter=True), device="cpu")
    assert_replicates_close(a.results[0], b.results[0], 1e-8)
    assert_replicates_close(a.results[0], c.results[0], 1e-9)


def test_two_fitted_models():
    """Replicates of several fitted models of different ranks come back per
    model; the batched driver sums its engine runs' iterations per rank."""
    x, kt2 = fitted_model(6, rank=2)
    kt3 = random_ktensor_host(np.random.default_rng(7), MODES, 3, dtype=np.float64)
    p = AlsParams(max_iterations=4, force_max_iter=True)
    rep = jk_cp_batched_als(x, [kt2, kt3], p, device="cpu")
    assert [len(r) for r in rep.results] == [MODES[0], MODES[0]]
    assert [r.lam.shape for r in (rep.results[0][0], rep.results[1][0])] == [(2,), (3,)]
    assert rep.cals_report.engine_iterations == {2: 4, 3: 4}
    cals = jk_cp_cals(x, [kt2, kt3], CalsParams(max_iterations=4, force_max_iter=True, bucket_ranks=(2, 3)),
                      device="cpu")
    for a, b in zip(rep.results, cals.results):
        assert_replicates_close(a, b, 1e-9)


def test_fidelity_pin_rules():
    """dimtree "auto" -> "off"; epilogue "auto" -> "fused" only on the card
    with the Gauss-Jordan solve; explicit settings pass through."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    p = pjk._pin_jk_fidelity(CalsParams(), cpu)
    assert (p.dimtree, p.epilogue) == ("off", "auto")
    assert pjk._pin_jk_fidelity(CalsParams(), cuda).epilogue == "fused"
    for solve in ("chol", "pallas"):
        q = pjk._pin_jk_fidelity(CalsParams(solve_method=solve), cuda)
        assert (q.epilogue, q.solve_method) == ("auto", solve)
    r = pjk._pin_jk_fidelity(CalsParams(dimtree="on", epilogue="xla"), cuda)
    assert (r.dimtree, r.epilogue) == ("on", "xla")


@pytest.mark.parametrize(
    "kwargs,item",
    [(dict(checkpoint_dir="ckpt"), "item 8"), (dict(resume=True), "item 8"),
     (dict(mesh=True), "item 10"), (dict(shard_mode0=True), "item 10")],
)
def test_jk_options_run(kwargs, item, tmp_path):
    """The options that raised until their items were ported now run:
    checkpoint and resume (item 8) give the plain run's replicates, and so
    does a mesh (item 10; here the single-process 1 x 1 mesh, the
    multi-process ones in tests/test_torch_sharded_cals.py). shard_mode0
    without a mesh is refused."""
    x, kt0 = make_problem(0)
    params = CalsParams(max_iterations=4, force_max_iter=True, bucket_ranks=(2,), buffer_size=4)
    if item == "item 10":
        if kwargs.get("shard_mode0"):
            with pytest.raises(ValueError, match="needs a mesh"):
                jk_cp_cals(x, [kt0], params, device="cpu", **kwargs)
            return
        from cp_cals_tpu_torch.parallel.sharding import make_mesh

        plain = jk_cp_cals(x, [kt0], params, device="cpu")
        got = jk_cp_cals(x, [kt0], params, mesh=make_mesh(device="cpu"))
        assert_replicates_close(plain.results[0], got.results[0], 0.0)
        return
    ckpt = str(tmp_path / "ckpt")
    plain = jk_cp_cals(x, [kt0], params, device="cpu")
    got = jk_cp_cals(x, [kt0], params, device="cpu", checkpoint_dir=ckpt)
    if kwargs.get("resume"):  # from the finished archive: nothing is refitted
        got = jk_cp_cals(x, [kt0], params, device="cpu", checkpoint_dir=ckpt, resume=True)
        assert sum(got.cals_report.engine_iterations.values()) == 0
    assert_replicates_close(plain.results[0], got.results[0], 0.0)
