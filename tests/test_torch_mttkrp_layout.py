"""The MTTKRP's tier-held X layout against the JAX package's prepare.

At "highest" the port holds X as [J, K, I] (i contiguous), a view of a
[J, K, Ip] block whose rows are padded with zeros to Ip, a multiple of 4:
the values of the JAX prepare's [J, I, K], transposed. At the bf16 tiers
the port rounds X once per solve (``prepare_mode_tensor``
with the tier): bf16 ``[J, I, Kp]`` at "default", the bf16 hi/lo pair
``[2, J, I, Kp]`` at "high", K padded with zeros to a multiple of 8. That
layout must hold exactly the values of the JAX prepare
(``cp_cals_tpu/ops/pallas_mttkrp.py:prepare_mode_tensor``) cast to bf16 and
split by ``_bf16_split``, and the plain version must give bit-identical
results on it and on X's own layout, which it rounds at every call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu.ops.mttkrp import mttkrp_batched as jax_mttkrp_batched
from cp_cals_tpu.ops.pallas_mttkrp import _bf16_split
from cp_cals_tpu.ops.pallas_mttkrp import prepare_mode_tensor as jax_prepare
from cp_cals_tpu_torch import CalsParams
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.solvers.iteration import make_iteration

MODES = (20, 13, 9)  # K = 13, 20, 20 for modes 0, 1, 2: Kp = 16, 24, 24


def _x(dtype=np.float32, seed=0):
    return np.random.default_rng(seed).normal(size=MODES).astype(dtype)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_held_layout_matches_jax_prepare(mode, precision):
    x = _x()
    held = fm.prepare_mode_tensor(torch.from_numpy(x), mode, precision)
    small, big = fm.split_others(MODES, mode)
    j, i, k = MODES[small], MODES[mode], MODES[big]
    kp = fm.padded_k(k)
    jx3 = jax_prepare(jnp.asarray(x), mode)
    assert jx3.shape[2] == kp  # both pad K to a multiple of 8
    planes = _bf16_split(jx3) if precision == "high" else (jx3.astype(jnp.bfloat16),)
    want = np.stack([np.asarray(p.astype(jnp.float32))[:j, :i, :kp] for p in planes])
    assert held.dtype == torch.bfloat16 and held.is_contiguous()
    assert tuple(held.shape) == ((2,) if precision == "high" else ()) + (j, i, kp)
    got = held.float().reshape(len(planes), j, i, kp).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[..., k:].any()  # the padding is zero


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_highest_layout_matches_jax_prepare(mode):
    x = _x()
    held = fm.prepare_mode_tensor(torch.from_numpy(x), mode)
    small, big = fm.split_others(MODES, mode)
    j, i, k = MODES[small], MODES[mode], MODES[big]
    ip = fm.padded_i(i)
    assert held.dtype == torch.float32 and tuple(held.shape) == (j, k, i)
    assert held.stride() == (k * ip, ip, 1) and ip % 4 == 0 and ip >= i
    want = np.asarray(jax_prepare(jnp.asarray(x), mode))[:j, :i, :k].transpose(0, 2, 1)
    np.testing.assert_array_equal(held.numpy(), want)
    block = torch.as_strided(held, (j, k, ip), (k * ip, ip, 1))
    assert not block[..., i:].any()  # the row padding is zero


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_on_highest_layout_matches_jax_fp64(mode):
    """The plain MTTKRP on the [J, K, I] layout against the JAX package's
    batched MTTKRP in float64, at the engine-parity band 1e-11 (the Pallas
    kernel itself sums in float32; tests/test_torch_kernels.py holds the
    port to it in float32 through the same layout)."""
    rng = np.random.default_rng(10 + mode)
    x = rng.normal(size=MODES)
    b, r = 3, 5
    u = [rng.normal(size=(b, m, r)) for m in MODES]
    want = jax_mttkrp_batched(jnp.asarray(x), tuple(jnp.asarray(f) for f in u), mode, method="krp_gemm")
    small, big = fm.split_others(MODES, mode)
    held = fm.prepare_mode_tensor(torch.from_numpy(x), mode)
    got = fm.fused_mttkrp(held, torch.from_numpy(u[small]), torch.from_numpy(u[big]))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_on_held_layout_is_bit_identical(mode, precision, dtype):
    """Rounding X once per solve gives the values that rounding it at every
    call gives: the plain version agrees bit for bit on both layouts."""
    rng = np.random.default_rng(mode)
    x = torch.from_numpy(_x(dtype, seed=mode + 1))
    b, r = 3, 5
    u = [torch.from_numpy(rng.normal(size=(b, m, r)).astype(dtype)) for m in MODES]
    small, big = fm.split_others(MODES, mode)
    held = fm.prepare_mode_tensor(x, mode, precision)
    own = fm.mode_layout(x, mode)  # X's own [J, I, K] layout
    got = fm.fused_mttkrp_plain(held, u[small], u[big], precision)
    want = fm.fused_mttkrp_plain(own, u[small], u[big], precision)
    assert got.dtype == want.dtype == x.dtype
    assert torch.equal(got, want)
    # on the CPU the kernel wrapper takes the held layout to the plain version
    assert torch.equal(fm.fused_mttkrp(held, u[small], u[big], precision), want)


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_iteration_prepares_the_mttkrp_tier_layout(tier):
    """The iteration holds X in the layout of the MTTKRP's tier (which may
    differ from the solve's precision)."""
    params = CalsParams(precision="highest" if tier != "highest" else "high", mttkrp_precision=tier)
    x = torch.from_numpy(_x())
    prepared = make_iteration(params).prepare(x)
    for mode, x3 in enumerate(prepared):
        assert torch.equal(x3, fm.prepare_mode_tensor(x, mode, tier))
        assert x3.dtype == (torch.float32 if tier == "highest" else torch.bfloat16)
    with pytest.raises(ValueError):
        fm.prepare_mode_tensor(x, 0, "medium")
