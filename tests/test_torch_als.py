"""The port's single-model and batched ALS against the JAX package, on the
CPU in float64 at the 1e-11 band of tests/test_als.py.

The port runs ``cp_als`` as a batch of one through its batched iteration
(the JAX package uses its unbatched one), with each of the three solves.
JAX runs ``solve_method="pallas"`` as "gj": its kernel cannot run inside
its solvers on the CPU, and both are the same unpivoted Gauss-Jordan
inverse up to rounding. JAX runs the twostep MTTKRP with the dimension
tree off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.als import cp_als as jax_cp_als
from cp_cals_tpu.solvers.als import cp_batched_als as jax_cp_batched_als
from cp_cals_tpu_torch import AlsParams, Ktensor, cp_als, cp_batched_als, random_ktensor_host
from cp_cals_tpu_torch.solvers.iteration import make_iteration

TOL = 1e-11
MODES = (9, 8, 7)
CASES = {
    "tol": dict(tol=1e-9, max_iterations=200),
    "forced": dict(max_iterations=12, force_max_iter=True),
}


def make_problem(seed, n_models=1, rank=3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(MODES)
    inits = [random_ktensor_host(rng, MODES, rank, dtype=np.float64) for _ in range(n_models)]
    return x, inits


def jkt(kt):
    return JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def jax_params(solve, **kw):
    return jcfg.AlsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off",
                          solve_method="gj" if solve == "pallas" else solve, **kw)


def assert_same_model(kp, kj, tol=TOL):
    for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
        np.testing.assert_allclose(fp, np.asarray(fj), atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("solve", ["gj", "chol", "pallas"])
def test_cp_als_fp64_matches_jax(case, solve):
    """The forced case runs a jackknife fiber with its leave-one-out norm."""
    x, (kt0,) = make_problem(0)
    jk = dict(jk_fiber=4, x_norm_model=float(np.linalg.norm(np.delete(x, 4, axis=0)))) if case == "forced" else {}
    kp, rp = cp_als(x, kt0, AlsParams(solve_method=solve, **CASES[case]), device="cpu", **jk)
    kj, rj = jax_cp_als(jnp.asarray(x), jkt(kt0), jax_params(solve, **CASES[case]), **jk)
    assert (rp.iters, rp.converged) == (rj.iters, rj.converged)
    np.testing.assert_allclose([rp.fit, rp.approx_error], [rj.fit, rj.approx_error], atol=TOL)
    assert_same_model(kp, kj)
    assert isinstance(kp.factors[0], np.ndarray) and kp.factors[0].shape == (MODES[0], 3)
    if jk:
        assert not kp.factors[0][4].any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("solve", ["gj", "chol", "pallas"])
def test_cp_batched_als_fp64_matches_jax(case, solve):
    x, inits = make_problem(1, n_models=4)
    res_p, reps_p = cp_batched_als(x, inits, AlsParams(solve_method=solve, **CASES[case]), device="cpu")
    res_j, reps_j = jax_cp_batched_als(jnp.asarray(x), [jkt(k) for k in inits], jax_params(solve, **CASES[case]))
    assert len(res_p) == len(res_j) == 4
    for kp, kj, rp, rj in zip(res_p, res_j, reps_p, reps_j):
        assert (rp.iters, rp.converged) == (rj.iters, rj.converged)
        np.testing.assert_allclose([rp.fit, rp.approx_error], [rj.fit, rj.approx_error], atol=TOL)
        assert_same_model(kp, kj)


def test_cp_batched_als_freezes_each_trajectory():
    """Each model of the batch follows cp_als's trajectory: converged
    models are frozen while the others iterate on. A stacked Ktensor and a
    list of models give the same results."""
    x, inits = make_problem(2, n_models=3)
    params = AlsParams(tol=1e-8)
    res, reps = cp_batched_als(x, inits, params, device="cpu")
    assert len({r.iters for r in reps}) > 1  # the models stop at different iterations
    for kt0, kb, rb in zip(inits, res, reps):
        ks, rs = cp_als(x, kt0, params, device="cpu")
        assert rs.iters == rb.iters
        assert_same_model(kb, ks, tol=1e-12)
    stacked = Ktensor(tuple(np.stack(fs) for fs in zip(*(k.factors for k in inits))),
                      np.stack([k.lam for k in inits]))
    res2, reps2 = cp_batched_als(x, stacked, params, device="cpu")
    for a, b, ra, rb in zip(res, res2, reps, reps2):
        assert ra == rb
        assert_same_model(a, b, tol=0.0)


def test_cp_als_float32_and_torch_inputs():
    """Torch inputs are taken as they are, and the tensor is cast to the
    model's dtype (float32 here: the kernels' plain versions)."""
    x, (kt0,) = make_problem(3)
    kt32 = Ktensor(tuple(torch.from_numpy(f.astype(np.float32)) for f in kt0.factors),
                   torch.from_numpy(kt0.lam.astype(np.float32)))
    kp, rp = cp_als(torch.from_numpy(x), kt32, AlsParams(max_iterations=5, force_max_iter=True), device="cpu")
    k64, r64 = cp_als(x, kt0, AlsParams(max_iterations=5, force_max_iter=True), device="cpu")
    assert kp.lam.dtype == np.float32 and rp.iters == 5
    assert abs(rp.fit - r64.fit) < 1e-4


def test_unbatched_iteration_is_not_ported():
    with pytest.raises(NotImplementedError, match="batch of one"):
        make_iteration(AlsParams(), batched=False)
