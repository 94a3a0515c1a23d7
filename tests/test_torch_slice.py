"""The port's slice as a whole against the JAX package, on the CPU.

fp64 (the algorithm): the port's iteration and ``cp_cals`` at both
epilogues against JAX with ``epilogue="xla"``, ``mttkrp_method=TWOSTEP``,
``dimtree="off"``, from the same explicit inits, at the 1e-11 band of
tests/test_cals.py. (JAX's ``mttkrp_method=PALLAS`` cannot run ``cp_cals``
on the CPU: the engine passes no ``interpret`` to the kernel.)

fp32 (the kernel configuration): the port at its default configuration
(fused MTTKRP + fused epilogue, plain versions on the CPU) against JAX
``cp_cals`` with ``epilogue="fused"`` (interpret mode), at the band of
tests/test_pallas_epilogue.py: 5e-4 on fit and error, 5e-3 on factors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu.solvers.iteration import make_iteration as jax_make_iteration
from cp_cals_tpu.solvers.state import init_state as jax_init_state
from cp_cals_tpu_torch import CalsParams, Ktensor, cp_cals, random_ktensor_host
from cp_cals_tpu_torch.convert import ktensor_from_numpy, params_from_dict, state_from_numpy
from cp_cals_tpu_torch.ktensor import to_tensor
from cp_cals_tpu_torch.solvers.iteration import make_iteration
from cp_cals_tpu_torch.solvers.state import init_state

TOL = 1e-11
MODES = (9, 8, 7)


def make_problem(seed, ranks, dtype=np.float64, noise=1e-3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=dtype)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + noise * rng.standard_normal(MODES)).astype(dtype)
    queue = [random_ktensor_host(rng, MODES, r, dtype=dtype) for r in ranks]
    return x, queue


def jax_queue(queue):
    return [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]


def jax_params(**kw):
    return jcfg.CalsParams(
        mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", **kw
    )


def recon(kt):
    return to_tensor(Ktensor(tuple(torch.as_tensor(np.array(f)) for f in kt.factors),
                             torch.as_tensor(np.array(kt.lam)))).numpy()


def assert_same_results(res_p, rep_p, res_j, rep_j, tol_fit, tol_recon, check_iters=True):
    assert len(res_p) == len(res_j)
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert mp.id == mj.id and mp.rank == mj.rank
        if check_iters:
            assert mp.iters == mj.iters, (mp.id, mp.iters, mj.iters)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=tol_fit)
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, atol=tol_fit, rtol=tol_fit)
        np.testing.assert_allclose(recon(kp), recon(kj), atol=tol_recon)


# ------------------------------------------------------------------- fp64


@pytest.mark.parametrize("epilogue", ["fused", "xla"])
def test_iteration_fp64_matches_jax(epilogue):
    """Three iterations from the same init, JK fibers on some models and
    a padded rank column; then one iteration from a carried JAX state."""
    x, queue = make_problem(0, ranks=(3, 3, 3, 3))
    b, r = 4, 4
    factors = [np.zeros((b, m, r)) for m in MODES]
    lam = np.zeros((b, r))
    for s, kt in enumerate(queue):
        for f_dst, f_src in zip(factors, kt.factors):
            f_dst[s, :, :3] = f_src
        lam[s, :3] = kt.lam
    mask = np.broadcast_to(np.arange(r) < 3, (b, r))
    jk = np.asarray([1, -1, 4, -1], np.int32)
    x_norm = float(np.linalg.norm(x))

    jit = jax_make_iteration(jax_params(epilogue="xla", force_max_iter=True), batched=True)
    xj = jnp.asarray(x)
    sj = jax_init_state(
        JKtensor(tuple(jnp.asarray(f) for f in factors), jnp.asarray(lam)),
        jnp.asarray(x_norm), jk_fiber=jnp.asarray(jk), rank_mask=jnp.asarray(mask),
    )
    pit = make_iteration(CalsParams(epilogue=epilogue, force_max_iter=True), batched=True)
    xt = torch.from_numpy(x)
    sp = init_state(
        ktensor_from_numpy(Ktensor(factors, lam), "cpu"), x_norm,
        jk_fiber=torch.from_numpy(jk), rank_mask=torch.from_numpy(mask.copy()),
    )
    prep = pit.prepare(xt)
    for _ in range(3):
        sj = jit(xj, sj, x_norm, jit.prepare(xj))
        sp = pit(xt, sp, x_norm, prep)
    sj_np = jax.tree.map(np.asarray, sj)
    for a, w in zip(sp.kt.factors, sj_np.kt.factors):
        np.testing.assert_allclose(a.numpy(), w, atol=TOL)
    for name in ("fit", "approx_error"):
        np.testing.assert_allclose(getattr(sp, name).numpy(), getattr(sj_np, name), atol=TOL)
    np.testing.assert_array_equal(sp.iters.numpy(), sj_np.iters)

    carried = state_from_numpy(sj_np, "cpu")
    sj2 = jax.tree.map(np.asarray, jit(xj, sj, x_norm, jit.prepare(xj)))
    sp2 = pit(xt, carried, x_norm, prep)
    for a, w in zip(sp2.kt.factors + (sp2.kt.lam,), sj2.kt.factors + (sj2.kt.lam,)):
        np.testing.assert_allclose(a.numpy(), w, atol=TOL)
    np.testing.assert_allclose(sp2.approx_error.numpy(), sj2.approx_error, atol=TOL)


@pytest.mark.parametrize(
    "case",
    [
        # small budget: eviction + refill, JK fibers, forced iterations
        dict(ranks=(1, 2, 3, 4, 5, 6, 2, 3), jk=(-1, 3, -1, 0, 8, -1, -1, 2),
             kw=dict(max_iterations=12, force_max_iter=True, buffer_size=12,
                     bucket_ranks=(2, 4, 8))),
        # tol-driven stopping with refills and tail compaction
        dict(ranks=(1, 2, 3, 4, 3, 2), jk=None,
             kw=dict(tol=1e-9, buffer_size=8, bucket_ranks=(2, 4))),
    ],
    ids=["forced_jk_refill", "tol_driven"],
)
@pytest.mark.parametrize("epilogue", ["fused", "xla"])
def test_cp_cals_fp64_matches_jax(case, epilogue):
    x, queue = make_problem(1, ranks=case["ranks"])
    jk = list(case["jk"]) if case["jk"] else None
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(epilogue="xla", **case["kw"]),
                               jk_fibers=jk)
    res_p, rep_p = cp_cals(x, queue, CalsParams(epilogue=epilogue, **case["kw"]),
                           jk_fibers=jk, device="cpu")
    assert_same_results(res_p, rep_p, res_j, rep_j, TOL, TOL)
    if jk:  # the left-out fiber stays zero in the mode-0 factor
        for kt, f in zip(res_p, jk):
            if f >= 0:
                assert not kt.factors[0][f].any()


def test_evict_batch_frozen_trajectories_bit_identical():
    """Deferred eviction freezes converged models: bit-identical results.
    (Slots stay put: no refill and no tail compaction, since BLAS may round
    a column differently at another position in the packed batch.)"""
    x, queue = make_problem(2, ranks=(2, 3, 4, 2, 3, 4))
    base = dict(tol=1e-8, buffer_size=32, bucket_ranks=(4,), epilogue="fused",
                tail_compaction_depth=0)
    res1, rep1 = cp_cals(x, queue, CalsParams(evict_batch=1, **base), device="cpu")
    res3, rep3 = cp_cals(x, queue, CalsParams(evict_batch=3, **base), device="cpu")
    for a, b, ma, mb in zip(res1, res3, rep1.models, rep3.models):
        assert ma.iters == mb.iters and ma.fit == mb.fit
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


# ------------------------------------------------------------------- fp32


def test_cp_cals_fp32_kernel_configuration_matches_jax_fused():
    x, queue = make_problem(3, ranks=(1, 2, 3, 3, 2), dtype=np.float32, noise=1e-2)
    kw = dict(max_iterations=6, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4))
    jk = [-1, 2, -1, 5, -1]
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(epilogue="fused", **kw),
                               jk_fibers=jk)
    params = CalsParams(**kw)  # auto -> fused MTTKRP + fused epilogue
    res_p, rep_p = cp_cals(x, queue, params, jk_fibers=jk, device="cpu")
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert mp.iters == mj.iters
        np.testing.assert_allclose(mp.fit, mj.fit, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(mp.approx_error, mj.approx_error, rtol=5e-4, atol=5e-4)
        assert kp.lam.dtype == np.float32
        for fp, fj in zip(kp.factors, kj.factors):
            np.testing.assert_allclose(fp, np.asarray(fj), rtol=5e-3, atol=5e-3)


def test_params_carry_over_from_jax():
    jp = jax_params(epilogue="fused", precision="high", mttkrp_precision="default",
                    bucket_ranks=(4, 8, 12, 16, 20), buffer_size=2880)
    pp = params_from_dict(dataclasses.asdict(jp))
    assert pp.mttkrp_method.value == "twostep" and pp.bucket_ranks == (4, 8, 12, 16, 20)
    assert pp == dataclasses.replace(
        CalsParams(), mttkrp_method=pp.mttkrp_method, dimtree="off", epilogue="fused",
        precision="high", mttkrp_precision="default",
        bucket_ranks=(4, 8, 12, 16, 20), buffer_size=2880,
        bucket_threads=4,  # JAX's default, carried over (the port's own is 1)
    )
