"""The port's single-model and batched ALS against the JAX package, on the
CPU in float64 at the 1e-11 band of tests/test_als.py.

Both packages run ``cp_als`` through their unbatched iteration (the
port's runs a batch of one through its batched iteration), with each of
the three solves.
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
    # The monotonicity hook on a converging fit (tests/test_als.py): no rise.
    "debug": dict(tol=1e-9, max_iterations=200, debug=True),
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
    from cp_cals_tpu_torch.solvers.iteration import MONOTONICITY_VIOLATIONS

    jk = dict(jk_fiber=4, x_norm_model=float(np.linalg.norm(np.delete(x, 4, axis=0)))) if case == "forced" else {}
    MONOTONICITY_VIOLATIONS.clear()
    kp, rp = cp_als(x, kt0, AlsParams(solve_method=solve, **CASES[case]), device="cpu", **jk)
    kj, rj = jax_cp_als(jnp.asarray(x), jkt(kt0), jax_params(solve, **CASES[case]), **jk)
    assert not MONOTONICITY_VIOLATIONS
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


@pytest.mark.parametrize("debug", [False, True])
def test_unbatched_iteration_matches_jax(debug):
    """make_iteration(batched=False) steps JAX's unbatched state (factors
    [I_n, R], scalar leaves) as JAX's unbatched iteration does, for 5
    float64 iterations from one state, at 1e-12. With debug=True the state
    is tests/test_als.py's monotonicity case: iteration 5 with a previous
    error of 0, so the first step records a rise in both packages, with a
    warning, and the next steps none."""
    from cp_cals_tpu.solvers.iteration import MONOTONICITY_VIOLATIONS as JAX_VIOLATIONS
    from cp_cals_tpu.solvers.iteration import make_iteration as jax_make_iteration
    from cp_cals_tpu.solvers.state import init_state as jax_init_state
    from cp_cals_tpu_torch.solvers.iteration import MONOTONICITY_VIOLATIONS
    from cp_cals_tpu_torch.solvers.state import init_state

    x, (kt0,) = make_problem(4)
    x_norm = float(np.linalg.norm(x))
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    sj = jax_init_state(jkt(kt0), jnp.asarray(x_norm))
    sp = init_state(Ktensor(tuple(torch.from_numpy(f) for f in kt0.factors), torch.from_numpy(kt0.lam)),
                    torch.tensor(x_norm, dtype=torch.float64))
    if debug:
        sj = sj._replace(iters=jnp.asarray(5, jnp.int32), approx_error=jnp.asarray(0.0, xj.dtype))
        sp = sp._replace(iters=torch.tensor(5, dtype=torch.int32), approx_error=torch.tensor(0.0, dtype=xp.dtype))
    step_j = jax_make_iteration(jax_params("gj", debug=debug), batched=False)
    step_p = make_iteration(AlsParams(debug=debug), batched=False)
    JAX_VIOLATIONS.clear()
    MONOTONICITY_VIOLATIONS.clear()
    for it in range(5):
        if debug and it == 0:
            with pytest.warns(UserWarning, match="error increased"):
                sj = step_j(xj, sj, jnp.asarray(x_norm))
                np.asarray(sj.fit)
            with pytest.warns(UserWarning, match="error increased"):
                sp = step_p(xp, sp, torch.tensor(x_norm, dtype=torch.float64))
        else:
            sj = step_j(xj, sj, jnp.asarray(x_norm))
            sp = step_p(xp, sp, torch.tensor(x_norm, dtype=torch.float64))
        assert sp.kt.factors[0].shape == MODES[:1] + (3,) and sp.iters.ndim == 0
        assert (int(sp.iters), bool(sp.converged)) == (int(sj.iters), bool(sj.converged))
        np.testing.assert_allclose([float(sp.fit), float(sp.approx_error)],
                                   [float(sj.fit), float(sj.approx_error)], atol=1e-12)
        for fp, fj in zip(sp.kt.factors + (sp.kt.lam,), sj.kt.factors + (sj.kt.lam,)):
            np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=1e-12)
    assert len(MONOTONICITY_VIOLATIONS) == len(JAX_VIOLATIONS) == (1 if debug else 0)
    np.testing.assert_allclose(MONOTONICITY_VIOLATIONS, JAX_VIOLATIONS, atol=1e-12)
