"""The port's batched SPD inverse and the solve methods of the unfused
epilogue, against the JAX package on the CPU.

``spd_inverse_plain`` (the plain version of ``csrc/spd_inverse.cu``) gets
the inputs of tests/test_ops.py's solve test and is held to JAX's
``spd_inverse_pallas`` in interpret mode within that test's float32 bound,
100 * cond(H) * eps32 relative to max|H^-1|; in float64 it agrees with
``gj_inverse`` to 1e-12. ``epilogue="auto"`` must honour a non-GJ
``solve_method``: the fused kernels always invert by Gauss-Jordan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.ops.pallas_solve import spd_inverse_pallas
from cp_cals_tpu.ops.update import update_factor_unconstrained as jax_update
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu_torch import CalsParams, cp_cals, random_ktensor_host
from cp_cals_tpu_torch import config as pcfg
from cp_cals_tpu_torch import probe_overhead as probe
from cp_cals_tpu_torch.ops import spd_inverse as si
from cp_cals_tpu_torch.ops import update as pupd

EPS32 = np.finfo(np.float32).eps


def _spd(seed, b, r, jitter):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, r, r))
    return a @ np.transpose(a, (0, 2, 1)) + jitter * np.eye(r)


@pytest.mark.parametrize("r,jitter", [(4, 1.0), (20, 1.0), (20, 1e-6)])
def test_spd_inverse_plain_matches_pallas_interpret(r, jitter):
    """The cases and bound of tests/test_ops.py:test_spd_solve_variants_agree."""
    h = _spd(3, 6, r, jitter)
    cond = np.linalg.cond(h).max()
    want = np.linalg.inv(h)
    scale = np.abs(want).max()
    h32 = h.astype(np.float32)
    got = si.spd_inverse_plain(torch.from_numpy(h32)).numpy().astype(np.float64)
    jax_got = np.asarray(spd_inverse_pallas(jnp.asarray(h32), interpret=True), np.float64)
    bound = 100 * cond * EPS32
    assert np.abs(got - want).max() / scale < bound
    assert np.abs(got - jax_got).max() / scale < bound
    # The wrapper takes the plain version for a CPU tensor.
    np.testing.assert_array_equal(si.spd_inverse(torch.from_numpy(h32)).numpy(), got.astype(np.float32))


@pytest.mark.parametrize("r", [1, 5, 8, 20])
def test_spd_inverse_plain_matches_gj_fp64(r):
    h = torch.from_numpy(_spd(r, 5, r, 0.5))
    got = si.spd_inverse_plain(h)
    want = pupd.gj_inverse(h)
    scale = want.abs().max()
    assert ((got - want).abs().max() / scale).item() < 1e-12


def test_spd_inverse_plain_identity_on_dead_slots():
    """Identity slots (the engine's dead models) come back exactly."""
    h = _spd(9, 6, 8, 1.0).astype(np.float32)
    h[[1, 4]] = np.eye(8, dtype=np.float32)
    got = si.spd_inverse_plain(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got[[1, 4]], np.broadcast_to(np.eye(8, dtype=np.float32), (2, 8, 8)))


def test_wrappers_raise_off_cpu_and_cuda():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        si.spd_inverse(torch.empty(2, 3, 3, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        probe.probe_copy(torch.empty(4, device=meta))


@pytest.mark.parametrize("shape", [(96, 20, 20), (7,), (0,)])
def test_probe_copy_plain_is_exact(shape):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    got = probe.probe_copy(x)
    assert torch.equal(got, x * np.float32(0.999))


def test_probe_needs_the_card():
    with pytest.raises(ValueError, match="no CPU mode"):
        probe.run_probe("cpu")


@pytest.mark.parametrize("solve", ["gj", "chol", "pallas"])
@pytest.mark.parametrize("hdim", [2, 3])
def test_update_solve_routes_and_matches_jax(solve, hdim, monkeypatch):
    """solve="pallas" reaches spd_inverse on a [B, R, R] batch and
    gj_inverse on one matrix, as the JAX package routes it; every solve
    gives JAX's factor to 1e-12 in float64."""
    rng = np.random.default_rng(4)
    b, i, r = 5, 17, 8
    h = _spd(4, b, r, r)
    g = rng.normal(size=(b, i, r))
    if hdim == 2:
        h, g = h[0], g[0]
    calls = []
    real = pupd.spd_inverse
    monkeypatch.setattr(pupd, "spd_inverse", lambda t: calls.append(t.shape) or real(t))
    got = pupd.update_factor_unconstrained(torch.from_numpy(g), torch.from_numpy(h), solve=solve)
    want = np.asarray(jax_update(jnp.asarray(g), jnp.asarray(h), solve="gj" if solve == "pallas" else solve))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=1e-12)
    assert len(calls) == (1 if solve == "pallas" and hdim == 3 else 0)


def test_update_rejects_unknown_solve():
    h = torch.eye(3, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="solve="):
        pupd.update_factor_unconstrained(torch.zeros(1, 4, 3, dtype=torch.float64), h, solve="lu")


@pytest.mark.parametrize(
    "epilogue,solve,want",
    [
        ("auto", "gj", "fused"), ("auto", "chol", "xla"), ("auto", "pallas", "xla"),
        ("fused", "gj", "fused"), ("xla", "gj", "xla"), ("xla", "chol", "xla"), ("xla", "pallas", "xla"),
        ("fused", "chol", ValueError), ("fused", "pallas", ValueError),
    ],
)
def test_resolve_epilogue(epilogue, solve, want):
    params = CalsParams(epilogue=epilogue, solve_method=solve)
    if want is ValueError:
        with pytest.raises(ValueError, match="cannot honour"):
            pcfg.resolve_epilogue(params)
    else:
        assert pcfg.resolve_epilogue(params) == want


def _problem(seed=1):
    rng = np.random.default_rng(seed)
    modes = (9, 8, 7)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(modes)
    queue = [random_ktensor_host(rng, modes, r, dtype=np.float64) for r in (1, 2, 3, 4, 2)]
    return x, queue


@pytest.mark.parametrize("solve,spy", [("chol", "cholesky_inverse"), ("pallas", "spd_inverse")])
def test_auto_epilogue_honours_solve_method(solve, spy, monkeypatch):
    """The fault repaired in config.resolve_epilogue: with epilogue="auto"
    the port resolved to the fused kernels whatever solve_method said, so
    "chol" never reached cholesky_inverse. Now the solve runs, and cp_cals
    gives JAX's unfused results (JAX runs "pallas" as "gj" on the CPU)."""
    calls = []
    real = getattr(pupd, spy)
    monkeypatch.setattr(pupd, spy, lambda h: calls.append(h.shape) or real(h))
    x, queue = _problem()
    kw = dict(max_iterations=6, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4))
    res_p, rep_p = cp_cals(x, queue, CalsParams(solve_method=solve, **kw), jk_fibers=[-1, 2, -1, 0, 5],
                           device="cpu")
    assert len(calls) == 3 * sum(rep_p.engine_iterations.values())
    jp = jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off",
                         solve_method="gj" if solve == "pallas" else solve, **kw)
    jq = [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jq, jp, jk_fibers=[-1, 2, -1, 0, 5])
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert mp.iters == mj.iters
        np.testing.assert_allclose(mp.fit, mj.fit, atol=1e-11)
        for fp, fj in zip(kp.factors + (kp.lam,), kj.factors + (kj.lam,)):
            np.testing.assert_allclose(fp, np.asarray(fj), atol=1e-10)
