"""The port's model and op modules against the JAX package, on the CPU.

ktensor.py, ops/gramians.py, ops/update.py, ops/error.py and the FLOP
counts of ops/mttkrp.py get the same numpy inputs as their JAX
counterparts. float64 results agree to 1e-12; the float32 compensated
error agrees with JAX's float32 compensated path (run here with x64 on,
so JAX would take its float64 path: it is called directly) to 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.ktensor as jkt
import cp_cals_tpu_torch.ktensor as pkt
import cp_cals_tpu_torch.ops.error as perr
import cp_cals_tpu_torch.ops.gramians as pgram
import cp_cals_tpu_torch.ops.mttkrp as pmtt
import cp_cals_tpu_torch.ops.update as pupd

# cp_cals_tpu.ops re-exports functions under its submodules' names.
jerr, jgram, jmtt, jupd = (
    importlib.import_module(f"cp_cals_tpu.ops.{m}") for m in ("error", "gramians", "mttkrp", "update")
)
TOL = 1e-12
MODES = (6, 5, 4)


def _batched(seed, b=3, r=4, pad=1, dtype=np.float64):
    rng = np.random.default_rng(seed)
    factors = []
    for m in MODES:
        f = rng.uniform(-1, 1, size=(b, m, r + pad)).astype(dtype)
        f[..., r:] = 0.0
        factors.append(f)
    lam = rng.uniform(0.5, 2, size=(b, r + pad)).astype(dtype)
    lam[..., r:] = 0.0
    mask = np.broadcast_to(np.arange(r + pad) < r, (b, r + pad)).copy()
    return factors, lam, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_random_ktensor_host_same_draws():
    for dtype in (np.float32, np.float64):
        a = pkt.random_ktensor_host(np.random.default_rng(3), MODES, 4, dtype=dtype)
        b = jkt.random_ktensor_host(np.random.default_rng(3), MODES, 4, dtype=dtype)
        for x, y in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            assert x.dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("iteration", [1, 2])
def test_normalize_paths(iteration):
    factors, lam, _ = _batched(0)
    # A column whose max and min tie in magnitude: the tie picks the max.
    factors[1][0, :, 0] = 0.0
    factors[1][0, 0, 0], factors[1][0, 1, 0] = 0.5, -0.5
    kt_p = pkt.Ktensor(tuple(_t(f) for f in factors), _t(lam))
    kt_j = jkt.Ktensor(tuple(jnp.asarray(f) for f in factors), jnp.asarray(lam))
    got, want = pkt.normalize_full(kt_p), jkt.normalize_full(kt_j)
    for g, w in zip(got.factors + (got.lam,), want.factors + (want.lam,)):
        _close(g, w)
    got, want = pkt.normalize_mode(kt_p, 1, iteration), jkt.normalize_mode(kt_j, 1, iteration)
    _close(got.lam, want.lam)
    _close(got.factors[1], want.factors[1])
    if iteration == 2:
        assert got.lam[0, 0].item() == 0.5
    for g, w in zip(pkt.normalize_factor_fused(_t(factors[1]), iteration),
                    jkt.normalize_factor_fused(jnp.asarray(factors[1]), iteration)):
        _close(g, w)


def test_ktensor_utilities():
    factors, lam, _ = _batched(1, b=1, pad=0)
    kt_p = pkt.Ktensor(tuple(_t(f[0]) for f in factors), _t(lam[0]))
    kt_j = jkt.Ktensor(tuple(jnp.asarray(f[0]) for f in factors), jnp.asarray(lam[0]))
    _close(pkt.to_tensor(kt_p), jkt.to_tensor(kt_j))
    d_p, d_j = pkt.denormalize(kt_p), jkt.denormalize(kt_j)
    _close(d_p.factors[0], d_j.factors[0])
    _close(d_p.lam, d_j.lam)
    padded = pkt.pad_rank(kt_p, 7)
    assert padded.rank == 7 and not padded.lam[4:].any()
    _close(pkt.to_tensor(pkt.truncate_rank(padded, 4)), jkt.to_tensor(kt_j))
    _close(pkt.to_tensor(padded), jkt.to_tensor(jkt.pad_rank(kt_j, 7)))
    with pytest.raises(ValueError):
        pkt.pad_rank(kt_p, 3)
    f0 = _batched(2)[0][0]
    fibers = np.array([2, -1, 0])
    _close(pkt.scale_jk_rows(_t(f0), _t(fibers)), jkt.scale_jk_rows(jnp.asarray(f0), jnp.asarray(fibers)))


@pytest.mark.parametrize("skip", [0, 1, 2])
def test_gramians_and_normal_solve(skip):
    factors, _, mask = _batched(4)
    gp = pgram.gramians([_t(f) for f in factors])
    gj = jgram.gramians([jnp.asarray(f) for f in factors])
    for a, b in zip(gp, gj):
        _close(a, b)
    _close(pgram.hadamard_all(gp), jgram.hadamard_all(gj))
    hp = pupd.padded_hadamard(pgram.hadamard_but_one(gp, skip), _t(mask))
    hj = jupd.padded_hadamard(jgram.hadamard_but_one(gj, skip), jnp.asarray(mask))
    _close(hp, hj)
    _close(pupd.gj_inverse(hp), jupd.gj_inverse(hj), 1e-9)
    _close(pupd.cholesky_inverse(hp), jupd.cholesky_inverse(hj), 1e-9)
    g = np.random.default_rng(5).normal(size=(3, MODES[skip], 5)) * mask[:, None, :]
    for solve in ("gj", "chol"):
        _close(pupd.update_factor_unconstrained(_t(g), hp, solve),
               jupd.update_factor_unconstrained(jnp.asarray(g), hj, solve=solve), 1e-9)


def _error_inputs(dtype):
    factors, lam, _ = _batched(6, dtype=dtype)
    rng = np.random.default_rng(7)
    g_last = rng.normal(size=factors[-1].shape).astype(dtype) * 3
    x_norm = np.array([40.0, 12.5, 7.25], dtype)
    return factors, lam, g_last, x_norm


def test_fast_error_fp64():
    factors, lam, g_last, x_norm = _error_inputs(np.float64)
    gh_p = pgram.hadamard_all(pgram.gramians([_t(f) for f in factors]))
    gh_j = jgram.hadamard_all(jgram.gramians([jnp.asarray(f) for f in factors]))
    want = jerr.fast_error(jnp.asarray(x_norm), jnp.asarray(lam), jnp.asarray(factors[-1]),
                           jnp.asarray(g_last), gh_j)
    _close(perr.fast_error(_t(x_norm), _t(lam), _t(factors[-1]), _t(g_last), gh_p), want, 1e-10)
    t3 = np.einsum("bir,bir->br", factors[-1], g_last)
    _close(perr.fast_error_from_cols(_t(x_norm), _t(lam), _t(t3), torch.zeros_like(_t(t3)), gh_p),
           want, 1e-10)


def test_fast_error_fp32_compensated():
    """fp32 state -> double-float path, against JAX's compensated path and
    against the float64 formula."""
    factors, lam, g_last, x_norm = _error_inputs(np.float32)
    gh = pgram.hadamard_all(pgram.gramians([_t(f) for f in factors]))
    got = perr.fast_error(_t(x_norm), _t(lam), _t(factors[-1]), _t(g_last), gh)
    assert got.dtype == torch.float32
    want = jerr._fast_error_compensated(
        jnp.asarray(x_norm), jnp.asarray(lam), jnp.asarray(factors[-1]), jnp.asarray(g_last),
        jnp.asarray(gh.numpy()),
    )
    _close(got, want, 1e-6)
    t3 = np.einsum("bir,bir->br", factors[-1].astype(np.float64), g_last.astype(np.float64))
    hi = t3.astype(np.float32)
    lo = (t3 - hi).astype(np.float32)
    from_cols = perr.fast_error_from_cols(_t(x_norm), _t(lam), _t(hi), _t(lo), gh)
    _close(from_cols, got, 5e-5)
    exact = perr.fast_error(_t(x_norm).double(), _t(lam).double(), _t(factors[-1]).double(),
                            _t(g_last).double(), gh.double())
    _close(got, exact, 1e-5)


def test_reconstruction_error_and_flops():
    factors, lam, _ = _batched(8, b=1, pad=0)
    kt_p = pkt.Ktensor(tuple(_t(f[0]) for f in factors), _t(lam[0]))
    kt_j = jkt.Ktensor(tuple(jnp.asarray(f[0]) for f in factors), jnp.asarray(lam[0]))
    x = np.random.default_rng(9).normal(size=MODES)
    _close(perr.reconstruction_error(_t(x), kt_p), jerr.reconstruction_error(jnp.asarray(x), kt_j))
    for mode in range(3):
        assert pmtt.mttkrp_flops((299, 301, 41), 20, mode, 32) == jmtt.mttkrp_flops(
            (299, 301, 41), 20, mode, 32)
    assert pmtt.als_iteration_flops((299, 301, 41), 12, 64) == jmtt.als_iteration_flops(
        (299, 301, 41), 12, 64)
