"""The port's MTTKRP methods against the JAX package's, on the CPU.

Same seeded numpy inputs through ``cp_cals_tpu/ops`` and
``cp_cals_tpu_torch/ops`` in float64: ``khatri_rao``, the single-model and
batched ``krp_gemm`` and ``twostep`` on ``tests/test_ops.py``'s shapes (2-D
to 5-D) for every mode, and the dimension tree's ``dimtree_ttm`` and
``dimtree_ttv``, at 1e-12 relative (the two sum in other orders). The tier
rule (``tier_matmul``) is held against a direct emulation of the bf16
roundings, and the fused MTTKRP's static gate against the twostep it sends
refused modes to, bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu_torch import CalsParams, MttkrpMethod, launches
from cp_cals_tpu_torch.config import resolve_mttkrp_method
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops import khatri_rao as kr
from cp_cals_tpu_torch.ops import mttkrp as mt

jax_kr = importlib.import_module("cp_cals_tpu.ops.khatri_rao")  # the package re-exports
jax_mt = importlib.import_module("cp_cals_tpu.ops.mttkrp")  # functions of these names

REL = 1e-12
SHAPES = [(4, 5), (7, 5, 6), (3, 4, 2, 5), (2, 3, 4, 2, 3), (8, 5, 5, 4)]


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


def _inputs(shape, b=3, r=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    factors = [rng.normal(size=(b, m, r)) for m in shape]
    return x, factors


def test_khatri_rao_matches_jax():
    rng = np.random.default_rng(1)
    a, b, c = rng.normal(size=(3, 4)), rng.normal(size=(5, 4)), rng.normal(size=(2, 4))
    _close(kr.khatri_rao(torch.from_numpy(a), torch.from_numpy(b)), jax_kr.khatri_rao(a, b), 0)
    _close(kr.khatri_rao_chain([torch.from_numpy(t) for t in (a, b, c)]),
           jax_kr.khatri_rao_chain([jnp.asarray(t) for t in (a, b, c)]), REL)
    ba, bb = rng.normal(size=(2, 3, 4)), rng.normal(size=(2, 5, 4))  # batched over leading dims
    _close(kr.khatri_rao(torch.from_numpy(ba), torch.from_numpy(bb)), jax_kr.khatri_rao(ba, bb), 0)


@pytest.mark.parametrize("method", ["krp_gemm", "twostep"])
@pytest.mark.parametrize("shape", SHAPES)
def test_single_model_mttkrp_matches_jax(shape, method):
    x, factors = _inputs(shape, seed=len(shape))
    for mode in range(len(shape)):
        want = jax_mt.mttkrp(jnp.asarray(x), [jnp.asarray(f[0]) for f in factors], mode, method)
        got = mt.mttkrp(torch.from_numpy(x), [torch.from_numpy(f[0]) for f in factors], mode, method)
        _close(got, want)


@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("method", ["krp_gemm", "twostep"])
@pytest.mark.parametrize("shape", SHAPES)
def test_batched_mttkrp_matches_jax(shape, method, prepared):
    x, factors = _inputs(shape, seed=10 + len(shape))
    xt = torch.from_numpy(x)
    held = mt.prepare_batched(xt, [method] * len(shape)) if prepared else [None] * len(shape)
    for mode in range(len(shape)):
        want = jax_mt.mttkrp_batched(jnp.asarray(x), tuple(jnp.asarray(f) for f in factors), mode, method)
        got = mt.mttkrp_batched(xt, [torch.from_numpy(f) for f in factors], mode, method,
                                prepared=held[mode])
        _close(got, want)


def test_prepare_unfoldings_matches_jax():
    x, _ = _inputs((3, 4, 2, 5), seed=2)
    for got, want in zip(mt.prepare_unfoldings(torch.from_numpy(x)), jax_mt.prepare_unfoldings(jnp.asarray(x))):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twostep_orders_ties_toward_the_highest_index():
    """Tied small modes (8, 5, 5, 4), target 3: the batched and single-model
    twosteps contract in one order, bit for bit (JAX's
    test_twostep_batched_matches_single_tied_small_modes)."""
    x, factors = _inputs((8, 5, 5, 4), b=3, r=2, seed=11)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in factors]
    assert mt._ts_big((8, 5, 5, 4), [0, 1, 2]) == 0 and mt._ts_big((8, 5, 5, 4), [1, 2, 3]) == 2
    for mode in range(4):
        g_b = mt.mttkrp_batched(xt, ft, mode, "twostep")
        for i in range(3):
            assert torch.equal(g_b[i], mt.mttkrp(xt, [f[i] for f in ft], mode, "twostep"))


@pytest.mark.parametrize("b,r", [(1, 3), (4, 2)])
def test_dimtree_matches_jax(b, r):
    x, factors = _inputs((6, 5, 4), b=b, r=r, seed=3)
    layout = mt.dimtree_layout(torch.from_numpy(x))
    assert torch.equal(layout, torch.from_numpy(np.array(jax_mt.dimtree_layout(jnp.asarray(x)))))
    for held in (None, layout):
        t = mt.dimtree_ttm(torch.from_numpy(x), torch.from_numpy(factors[0]), prepared=held)
        t_j = jax_mt.dimtree_ttm(jnp.asarray(x), jnp.asarray(factors[0]))
        _close(t, t_j)
        for mode in (1, 2):
            got = mt.dimtree_ttv(t, [torch.from_numpy(f) for f in factors], mode)
            want = jax_mt.dimtree_ttv(t_j, tuple(jnp.asarray(f) for f in factors), mode)
            _close(got, want)
            # and it is the mode's MTTKRP
            _close(got, jax_mt.mttkrp_batched(jnp.asarray(x), tuple(jnp.asarray(f) for f in factors), mode,
                                              "twostep"), 1e-11)


def _emulate(a, b, precision):
    """The tier rule written out in numpy: bf16 roundings by truncating the
    float32 bit pattern with round-to-nearest-even, products in float64."""
    def bf16(t):
        bits = np.asarray(t, np.float32).view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return bits.astype(np.uint32).view(np.float32).astype(np.float64)

    if precision == "highest":
        return a @ b
    ah, bh = bf16(a), bf16(b)
    out = ah @ bh
    if precision == "high":
        out = out + ah @ bf16(b - bh) + bf16(a - ah) @ bh
    return out


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tier_matmul_matches_a_direct_emulation(precision, batched):
    rng = np.random.default_rng(5)
    shape_a, shape_b = ((3, 17, 23), (3, 23, 9)) if batched else ((17, 23), (23, 9))
    a = rng.normal(size=shape_a).astype(np.float32).astype(np.float64)
    b = rng.normal(size=shape_b).astype(np.float32).astype(np.float64)
    got = mt.tier_matmul(torch.from_numpy(a), torch.from_numpy(b), precision)
    want = _emulate(a, b, precision)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
    if precision == "default":
        # The compact intermediate: the result rounded to bf16 values.
        c = mt.tier_matmul(torch.from_numpy(a), torch.from_numpy(b), precision, torch.bfloat16)
        assert torch.equal(c, c.to(torch.bfloat16).to(c.dtype))
        np.testing.assert_allclose(c.numpy(), want, rtol=2 ** -8)
    if precision != "highest":  # the rounding is real: the strict product differs
        assert np.abs(got.numpy() - a @ b).max() > 1e-6


@pytest.mark.parametrize("precision", ["high", "default"])
def test_twostep_tiers_follow_the_rule(precision):
    """The batched twostep at a bf16 tier equals the twostep written with
    the rule's products step by step (float64 working dtype)."""
    x, factors = _inputs((6, 5, 4), b=2, r=3, seed=8)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in factors]
    got = mt.mttkrp_batched(xt, ft, 1, "twostep", precision)
    # mode 1: big = 0 (6), small = [2]; at "default" the TTM's output is
    # rounded to bf16 (the compact intermediate)
    t = mt.tier_matmul(mt._ts_layout(xt, 1), ft[0].permute(1, 0, 2).reshape(6, 6), precision,
                       torch.bfloat16 if precision == "default" else None)
    tb = t.reshape(5, 4, 6).movedim(-1, 0)  # [C, I_1, I_2]
    u = ft[2].permute(1, 0, 2).reshape(4, 6)
    want = torch.stack([mt.tier_matmul(tb[c], u[:, c:c + 1], precision)[:, 0] for c in range(6)])
    assert torch.allclose(got, want.reshape(2, 3, 5).permute(0, 2, 1), rtol=1e-14, atol=1e-14)


def test_fused_gate_on_the_cpu_takes_3d_only():
    for shape, want in (((4, 5, 6), True), ((4, 5), False), ((3, 4, 2, 5), False)):
        for mode in range(len(shape)):
            assert fm.fused_mttkrp_supported(shape, mode, 2, 3, torch.float64, "cpu") is want
    assert mt.resolve_batched_method("pallas", (3, 4, 2, 5), 1, torch.float32, "cpu") == "twostep"
    assert resolve_mttkrp_method(CalsParams(), (4, 5, 6), torch.float32, "cpu") == ("pallas",) * 3
    assert resolve_mttkrp_method(CalsParams(), (4, 5, 6, 2), torch.float32, "cpu") == ("twostep",) * 4
    p = CalsParams(mttkrp_method=MttkrpMethod.KRP_GEMM)
    assert resolve_mttkrp_method(p, (4, 5, 6, 2), torch.float32, "cpu") == ("krp_gemm",) * 4


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_a_mode_the_fused_gate_refuses_takes_the_twostep(monkeypatch, precision):
    """With the gate patched to refuse mode 1, ``mttkrp_batched`` sends it
    to the twostep (route count and bits), and the other modes to the fused
    kernels' plain version."""
    x, factors = _inputs((7, 5, 6), b=2, r=3, seed=9)
    xt, ft = torch.from_numpy(x).float(), [torch.from_numpy(f).float() for f in factors]
    real = fm.fused_mttkrp_supported
    monkeypatch.setattr(mt, "fused_mttkrp_supported",
                        lambda shape, mode, b, r, dtype, device: mode != 1 and real(shape, mode, b, r, dtype, device))
    held = mt.prepare_batched(xt, ["pallas"] * 3, precision)
    assert held[1].shape == (5 * 6, 7) and held[1].dtype == torch.float32  # the twostep's layout
    launches.reset()
    for mode in range(3):
        got = mt.mttkrp_batched(xt, ft, mode, "pallas", precision, held[mode])
        want = (mt.mttkrp_batched_twostep(xt, ft, mode, precision) if mode == 1
                else fm.fused_mttkrp_plain(fm.prepare_mode_tensor(xt, mode, precision), *(
                    ft[m] for m in fm.split_others(xt.shape, mode)), precision))
        assert torch.equal(got, want)
    assert launches.routes() == {"fused": 2, "twostep": 1, "krp_gemm": 0, "dimtree": 0}


def test_flop_counts_match_jax():
    for shape in SHAPES:
        for mode in range(len(shape)):
            assert mt.mttkrp_flops(shape, 5, mode, 3) == jax_mt.mttkrp_flops(shape, 5, mode, 3)
        assert mt.als_iteration_flops(shape, 5, 3) == jax_mt.als_iteration_flops(shape, 5, 3)
