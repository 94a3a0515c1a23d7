"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same inputs on
the card, and ``cp_cals`` on the card against the same run on the CPU. The
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) Without a
card every test skips. Tolerances are fp32 ones: the kernels sum in
another order than cuBLAS (MTTKRP 2e-5 relative, epilogue 2e-4, or 1e-5
of the largest magnitude at the engine's shapes); both
inverses are held per model to 1e-6 * cond(H) * max|H^-1| (their plain
versions round the same elimination, with FMAs at other places); the
probe's copy kernel is exact.
"""

import numpy as np
import pytest
import torch

from cp_cals_tpu_torch import (
    AlsParams,
    CalsParams,
    cp_als,
    cp_batched_als,
    cp_cals,
    jk_cp_cals,
    random_ktensor_host,
)
from cp_cals_tpu_torch import probe_overhead as probe
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops import spd_inverse as si
from cp_cals_tpu_torch.ops.gramians import gramians

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_mttkrp_kernel_matches_plain(dev, precision):
    """Odd rank, ragged tiles, and a short target mode that splits j."""
    rng = np.random.default_rng(1)
    modes, b, r = (70, 45, 33), 5, 7
    x = torch.from_numpy(rng.normal(size=modes).astype(np.float32)).to(dev)
    fs = [torch.from_numpy(rng.normal(size=(b, m, r)).astype(np.float32)).to(dev) for m in modes]
    for mode in range(3):
        got = fm.mttkrp_batched_fused(x, fs, mode, precision=precision)
        small, big = fm.split_others(modes, mode)
        want = fm.fused_mttkrp_plain(fm.prepare_mode_tensor(x, mode, precision), fs[small], fs[big],
                                     precision)
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 2e-5 * scale


# The tensor-core kernel's edge shapes: (tensor modes, B, R, target mode).
TC_CASES = [
    ((30, 301, 41), 5, 1, 0),     # R = 1; K = 301, not a multiple of 8
    ((30, 299, 41), 9, 4, 1),     # B*R = 36: one partial column tile
    ((70, 45, 33), 5, 7, 1),      # odd rank; B*R = 35
    ((40, 33, 25), 11, 20, 2),    # R = 20; B*R = 220 spans two tiles, the second partial
    ((299, 301, 41), 12, 8, 2),   # I = 41: one partial row tile, j split across blocks
    ((1, 20, 30), 1, 3, 1),       # B = 1 and J = 1
    ((64, 64, 1000), 16, 32, 2),  # K = 64, one stage per j, each carrying a U1 row; 16 j per block
    ((17, 17, 4000), 16, 32, 2),  # K = 17, one partial k-step; 17 j per block
    ((3, 70, 3001), 6, 5, 0),     # K = 3,001: U2 does not fit whole at "high", k split
    ((2, 40, 6007), 3, 8, 0),     # K = 6,007: k split at both tiers
]


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("modes,b,r,mode", TC_CASES)
def test_mttkrp_tc_kernel_matches_plain(dev, precision, modes, b, r, mode):
    """The wgmma kernel on the tier's held layout against the plain version
    on the same layout, at 2e-5 * max|G|."""
    rng = np.random.default_rng(sum(modes) + b + r)
    x = torch.from_numpy(rng.normal(size=modes).astype(np.float32)).to(dev)
    fs = [torch.from_numpy(rng.normal(size=(b, m, r)).astype(np.float32)).to(dev) for m in modes]
    small, big = fm.split_others(modes, mode)
    x3 = fm.prepare_mode_tensor(x, mode, precision)
    before = fm.fused_mttkrp_tc.launches
    got = fm.fused_mttkrp_tc(x3, fs[small], fs[big], precision)
    torch.cuda.synchronize()
    assert fm.fused_mttkrp_tc.launches == before + 1
    want = fm.fused_mttkrp_plain(x3, fs[small], fs[big], precision)
    assert got.shape == want.shape == (b, modes[mode], r)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale


def test_mttkrp_tc_rejects_a_mistyped_layout(dev):
    """The bf16 tiers take only their own held layout: contiguous, 16-byte
    aligned bfloat16 with K padded to Kp."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(6, 5, 11)).astype(np.float32)).to(dev)
    u1 = torch.zeros(2, 6, 3, device=dev)  # mode 1: J = 6 (mode 0), K = 11 (mode 2)
    u2 = torch.zeros(2, 11, 3, device=dev)
    held = {p: fm.prepare_mode_tensor(x, 1, p) for p in fm.TIERS}
    assert held["default"].shape == (6, 5, 16) and held["high"].shape == (2, 6, 5, 16)
    misaligned = torch.zeros(1 + 6 * 5 * 16, dtype=torch.bfloat16, device=dev)[1:].view(6, 5, 16)
    bad = [
        (held["highest"], "default"),            # float32, K not padded
        (held["default"].float(), "default"),    # float32 of the padded layout
        (held["high"], "default"),               # two planes at one-plane tier
        (held["default"], "high"),               # one plane at the two-plane tier
        (held["default"][..., :11], "default"),  # K not padded to Kp
        (held["high"].transpose(0, 1).contiguous().transpose(0, 1), "high"),  # not contiguous
        (misaligned, "default"),                 # not 16-byte aligned
        (held["default"], "highest"),            # not a bf16 tier
    ]
    for x3, precision in bad:
        with pytest.raises(ValueError):
            fm.fused_mttkrp_tc(x3, u1, u2, precision)
    with pytest.raises(ValueError):  # the fp32 kernel does not take a held bf16 layout
        fm.fused_mttkrp(held["default"], u1, u2, "highest")
    with pytest.raises(ValueError):  # u1 in another dtype
        fm.fused_mttkrp_tc(held["default"], u1.double(), u2, "default")


# The fp32 ("highest") kernel's edge shapes: (I, K, J, B, R), the target mode
# first in a tensor (I, K, J), K >= J, so that K is the contracted mode.
FP32_CASES = [
    (1, 301, 30, 5, 7),      # I = 1: one row of the 48-row tile
    (41, 301, 299, 12, 8),   # I = 41, the engine's short mode (J = 299, K = 301): j split
    (64, 17, 9, 9, 20),      # I = 64, one 64-row tile; K = 17, one partial stage; C = 180
    (65, 301, 41, 7, 64),    # I = 65: a partial 48-row tile; R = 64; C = 448
    (299, 301, 41, 32, 20),  # the engine's mode 0 at B*R = 640
    (299, 3001, 3, 6, 5),    # K = 3,001: U2 split into k ranges
    (41, 3001, 2, 3, 1),     # R = 1 with a k split
    (20, 30, 1, 1, 3),       # B = J = 1
    (1, 17, 1, 1, 1),        # I = J = B = R = 1
]


@pytest.mark.parametrize("i,k,j,b,r", FP32_CASES)
def test_mttkrp_fp32_kernel_matches_plain(dev, i, k, j, b, r):
    """The CUDA-core kernel on the held [J, K, I] layout against the plain
    version on the same layout, at 2e-5 * max|G|; a second call is
    bit-identical (no atomics, fixed-order split sums)."""
    rng = np.random.default_rng(i + k + j + b + r)
    x = torch.from_numpy(rng.normal(size=(i, k, j)).astype(np.float32)).to(dev)
    u1 = torch.from_numpy(rng.normal(size=(b, j, r)).astype(np.float32)).to(dev)
    u2 = torch.from_numpy(rng.normal(size=(b, k, r)).astype(np.float32)).to(dev)
    assert fm.split_others(tuple(x.shape), 0) == (2, 1)
    x3 = fm.prepare_mode_tensor(x, 0)
    before = fm.fused_mttkrp_fp32.launches
    got = fm.fused_mttkrp_fp32(x3, u1, u2)
    again = fm.fused_mttkrp_fp32(x3, u1, u2)
    torch.cuda.synchronize()
    assert fm.fused_mttkrp_fp32.launches == before + 2
    want = fm.fused_mttkrp_plain(x3, u1, u2, "highest")
    assert got.shape == want.shape == (b, i, r)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    assert torch.equal(got, again)


def test_fp32_planner_tables_match_the_built_kernel(dev):
    """The planner's tile table and shared-memory sizes, used without a card,
    are the built kernel's own."""
    assert fm.fp32_tiles_built() == fm.FP32_TILES
    smem = fm._lib_fp32().fused_mttkrp_fp32_smem
    for tile in fm.FP32_TILES:
        for kspan in range(16, 4097, 16):
            assert smem(tile, kspan) == fm.fp32_smem(tile, kspan)
    assert smem(max(fm.FP32_TILES) + 1, 16) == -1


def test_mttkrp_fp32_rejects_a_mistyped_layout(dev):
    """The "highest" tier takes only its held layout: float32 [J, K, I], rows
    of a stride that is a multiple of 4, 16-byte aligned."""
    u1, u2 = torch.zeros(2, 6, 3, device=dev), torch.zeros(2, 11, 3, device=dev)
    x = torch.zeros(5, 11, 6, device=dev)  # (I, K, J): mode 0 has J = 6, K = 11, I = 5
    held = fm.prepare_mode_tensor(x, 0)
    assert held.shape == (6, 11, 5) and held.stride() == (88, 8, 1)
    block = torch.zeros(1 + 6 * 11 * 8, device=dev)[1:]
    bad = [
        held.contiguous(),                                   # row stride 5, not a multiple of 4
        held.transpose(1, 2).contiguous().transpose(1, 2),   # i not contiguous
        torch.as_strided(block, (6, 11, 5), (88, 8, 1)),     # not 16-byte aligned
        torch.zeros(6, 5, 11, device=dev),                   # X's own [J, I, K] layout
    ]
    for x3 in bad:
        with pytest.raises(ValueError):
            fm.fused_mttkrp_fp32(x3, u1, u2)
    fm.fused_mttkrp_fp32(held, u1, u2)


def _apply_problem(dev, mode, b=7, modes=(299, 301, 41), r=12, pad=4, seed=0):
    """Normalized factors (padded ranks, a model of lower rank, slot b-1
    dead), their gramians, G of mode ``mode``, jackknife fibers and model
    norms, on the card."""
    rng = np.random.default_rng(seed + mode)
    rr = r + pad
    mask = np.broadcast_to(np.arange(rr) < r, (b, rr)).copy()
    mask[-1] = False
    mask[1, r - 3:] = False
    m = torch.from_numpy(mask).to(dev)
    factors = []
    for n in modes:
        f = torch.from_numpy(rng.normal(size=(b, n, rr)).astype(np.float32)).to(dev) * m[:, None, :]
        factors.append(f / torch.clamp(torch.linalg.vector_norm(f, dim=1, keepdim=True), min=1e-30))
    g = torch.from_numpy(rng.normal(size=(b, modes[mode], rr)).astype(np.float32)).to(dev) * m[:, None, :]
    jk = torch.tensor([2, -1, 0, -1, 40, -1, 7][:b], dtype=torch.int32, device=dev)
    # |X| well above the fitted terms, as in the engine, so err^2 does not cancel to 0
    x_norm = torch.from_numpy(rng.uniform(40.0, 60.0, size=b).astype(np.float32)).to(dev)
    return m, gramians(factors), g, jk, x_norm


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_apply_kernel_matches_plain(dev, mode):
    """F, lam and the rescaled gramian at 1e-5 of their largest magnitude,
    and on the last mode the error at 1e-5 relative: the kernel's F and
    gramian differ from the plain version's at fp32 rounding, and the error
    carries that through its double-float sums. The dead slot stays inert."""
    m, grams, g, jk, x_norm = _apply_problem(dev, mode)
    b = g.shape[0]
    hinv = fe.normal_inverse(grams, m, mode)
    err_inputs = (x_norm, grams[0], grams[1]) if mode == 2 else None
    for iters_val in (1, 4):
        iters = torch.full((b,), iters_val, dtype=torch.int32, device=dev)
        for zero_jk in (False, True):
            before = fe.epilogue_apply.launches
            got = fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)
            torch.cuda.synchronize()
            assert fe.epilogue_apply.launches == before + 1
            want = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk, err_inputs)
            for a, w in zip(got[:3], want[:3]):
                assert a.shape == w.shape
                assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item()
            if mode == 2:
                assert got[3].shape == (b,)
                assert ((got[3] - want[3]).abs() <= 1e-5 * want[3].abs()).all()
                assert got[3][-1].item() == pytest.approx(x_norm[-1].item(), rel=1e-6)
            else:
                assert got[3] is None and want[3] is None
            assert not got[0][-1].any() and not got[1][-1].any() and not got[2][-1].any()
            if zero_jk and mode == 0:
                for slot, fiber in enumerate(jk.tolist()):
                    if fiber >= 0:
                        assert not got[0][slot, fiber].any()


@pytest.mark.parametrize("r", [4, 5, 20, 64])
def test_apply_kernel_takes_the_largest_i(dev, r):
    """The apply takes every I whose H^-1, G and four R-vectors fit one
    block's shared memory (R^2 + I R + 4 R floats), the error included, and
    matches the plain version there; one row more is refused."""
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    i_max = (optin // 4 - r * r - 4 * r) // r
    assert fe._lib().apply_smem_bytes(i_max, r) <= optin < fe._lib().apply_smem_bytes(i_max + 1, r)
    m, grams, g, jk, _ = _apply_problem(dev, 2, b=3, modes=(9, 8, i_max), r=r, pad=0, seed=r)
    hinv = fe.normal_inverse(grams, m, 2)
    for iters_val, zero_jk in ((1, True), (4, False)):
        iters = torch.full((3,), iters_val, dtype=torch.int32, device=dev)
        # |X| such that err^2 is half the size of the error's terms (random G
        # is no fit of any X); 0 for the dead slot.
        f, lam, gm, _ = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk)
        lam = lam.double()
        t2 = torch.einsum("bi,bj,bij->b", lam, lam, grams[0].double() * grams[1].double() * gm.double())
        t3 = torch.einsum("bc,bic,bic->b", lam, f.double(), g.double())
        x_norm = torch.sqrt((2 * t3 - t2 + 0.5 * (t2.abs() + 2 * t3.abs())).clamp(min=0)).float()
        err_inputs = (x_norm, grams[0], grams[1])
        got = fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)
        want = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk, err_inputs)
        torch.cuda.synchronize()
        for a, w in zip(got[:3], want[:3]):
            assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item()
        assert ((got[3] - want[3]).abs() <= 1e-5 * want[3].abs()).all()
        assert not got[0][-1].any() and not got[1][-1].any() and not got[2][-1].any()
    g1 = torch.zeros(3, i_max + 1, r, device=dev)
    with pytest.raises(ValueError):
        fe.epilogue_apply(g1, hinv, iters, jk, False, None)


def test_apply_kernel_rejects_mistyped_error_inputs(dev):
    m, grams, g, jk, x_norm = _apply_problem(dev, 2, b=3, modes=(9, 8, 7), r=3, pad=1)
    hinv = fe.normal_inverse(grams, m, 2)
    iters = torch.ones(3, dtype=torch.int32, device=dev)
    bad = [
        (x_norm.double(), grams[0], grams[1]),          # x_norm float64
        (x_norm[:2], grams[0], grams[1]),               # x_norm of another batch
        (x_norm.cpu(), grams[0], grams[1]),             # x_norm on the CPU
        (x_norm, grams[0].double(), grams[1]),          # a gramian in float64
        (x_norm, grams[0], grams[1][:, :3, :3]),        # a gramian of another rank
        (x_norm, grams[0], grams[1].transpose(1, 2)),   # not contiguous
    ]
    for err_inputs in bad:
        with pytest.raises(ValueError):
            fe.epilogue_apply(g, hinv, iters, jk, False, err_inputs)
    fe.epilogue_apply(g, hinv, iters, jk, False, (x_norm, grams[0], grams[1]))


# Both inverses at every boundary of their launch plan (csrc/gj_elim.cuh:
# the warp path up to R = 32, four models per block; the block path above).
GJ_RANKS = [1, 2, 4, 5, 8, 12, 16, 20, 31, 32, 33, 48, 64]


def _hinv_ratio(got, want, h):
    """Per model: |kernel - plain| over cond(H) * max|plain|, cond in float64."""
    cond = torch.linalg.cond(h.double())
    err = (got.double() - want.double()).abs().amax((1, 2))
    return err / (cond * want.double().abs().amax((1, 2)))


def _check_inverse(got, want, h):
    """The check chip_smoke.py holds both inverses to: each model within
    1e-6 * cond(H) * max|H^-1| of the plain version, where the first-order
    inverse 2I - H fails."""
    assert (_hinv_ratio(got, want, h) <= 1e-6).all()
    eye = torch.eye(h.shape[-1], device=h.device).expand_as(h)
    assert not (_hinv_ratio(2 * eye - h, want, h) <= 1e-6).all()


@pytest.mark.parametrize("r", GJ_RANKS)
def test_epilogue_kernels_match_plain(dev, r):
    rng = np.random.default_rng(5 + r)
    # The normal inverse on SPD gramians with cond(H) up to 1e4, B = 7 (not
    # a multiple of the warp path's four models per block) and B = 1; true
    # ranks r - 2 .. r (masked columns) and a dead slot, which come out
    # exactly as the identity.
    b = 7
    g0 = torch.from_numpy(_spd_batch(rng, b, r, 1e4).astype(np.float32)).to(dev)
    g1 = (torch.ones(r, r, device=dev) + 0.5 * torch.eye(r, device=dev)).expand(b, r, r).contiguous()
    true = torch.tensor([max(1, r - s % 3) for s in range(b)])
    true[-1] = 0
    m = (torch.arange(r)[None, :] < true[:, None]).to(dev)
    eye = torch.eye(r, device=dev).expand(b, r, r)
    pad = ~m[:, :, None] | ~m[:, None, :]
    for skip in range(3):
        grams = [g0, g1]
        grams.insert(skip, torch.full((b, r, r), float("nan"), device=dev))  # never read
        before = fe.normal_inverse.launches
        got = fe.normal_inverse(grams, m, skip)
        assert fe.normal_inverse.launches == before + 1
        want = fe.normal_inverse_plain(grams, m, skip)
        torch.cuda.synchronize()
        h = torch.where(pad, eye, g0 * g1)
        live = m.any(1)
        _check_inverse(got[live], want[live], h[live])
        assert torch.equal(got[pad], eye[pad])
        one = fe.normal_inverse([g[:1] for g in grams], m[:1], skip)
        assert torch.equal(one, got[:1])
    # The apply on the kernel's H^-1 of random factors' gramians.
    modes, pad_cols = (2 * r + 9, 2 * r + 8, 7), min(2, r - 1)
    mask = np.broadcast_to(np.arange(r) < r - pad_cols, (b, r)).copy()
    mask[-1] = False
    m = torch.from_numpy(mask).to(dev)
    factors = [torch.from_numpy(rng.normal(size=(b, n, r)).astype(np.float32)).to(dev) * m[:, None, :]
               for n in modes]
    grams = gramians(factors)
    for skip in range(3):
        hinv = fe.normal_inverse(grams, m, skip)
        torch.testing.assert_close(hinv, fe.normal_inverse_plain(grams, m, skip), rtol=2e-4, atol=2e-4)
    g = torch.from_numpy(rng.normal(size=(b, modes[2], r)).astype(np.float32)).to(dev) * m[:, None, :]
    jk = torch.tensor([2, -1, 0, -1, 4, -1, 6], dtype=torch.int32, device=dev)
    x_norm = torch.linspace(20.0, 30.0, b, device=dev)
    for iters_val in (1, 3):
        iters = torch.full((b,), iters_val, dtype=torch.int32, device=dev)
        for zero_jk in (False, True):
            for with_err in (False, True):
                err_inputs = (x_norm, grams[0], grams[1]) if with_err else None
                got = fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)
                want = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk, err_inputs)
                for a, w in zip(got[:3], want[:3]):
                    torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
                if with_err:
                    torch.testing.assert_close(got[3], want[3], rtol=2e-4, atol=2e-4)
                assert not got[0][-1].any() and not got[1][-1].any()


def test_inverse_launch_plan_matches_the_built_kernels(dev):
    for r in range(1, si.MAX_R + 1):
        for b in (1, 3, 4, 5, 96, 97, 320):
            assert si.built_plan(b, r) == si.gj_plan(b, r)


def test_kernels_reject_what_they_do_not_take(dev):
    g = torch.zeros(2, 4, 3, device=dev)
    h = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    i32 = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fe.epilogue_apply(g.double(), h.double(), i32, i32, False, None)
    with pytest.raises(ValueError):
        fe.epilogue_apply(torch.zeros(2, 4, fe.MAX_R + 1, device=dev),
                          torch.zeros(2, fe.MAX_R + 1, fe.MAX_R + 1, device=dev), i32, i32, False, None)
    eye = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError):  # the kernel takes a 3-D tensor's two other gramians
        fe.normal_inverse((eye,) * 4, torch.ones(2, 3, dtype=torch.bool, device=dev), 0)
    x3 = torch.zeros(3, 4, 5, device=dev)
    with pytest.raises(ValueError):
        fm.fused_mttkrp(x3.double(), torch.zeros(2, 3, 2, device=dev).double(),
                        torch.zeros(2, 5, 2, device=dev).double())
    with pytest.raises(ValueError):
        fm.fused_mttkrp(x3, torch.zeros(2, 3, 2, device=dev), torch.zeros(2, 6, 2, device=dev))


def test_cp_cals_on_card_matches_cpu(dev):
    """The engine through the kernels (refills, jackknife fibers) against
    the same fp32 run on the CPU through the plain versions."""
    rng = np.random.default_rng(2)
    modes = (20, 17, 9)
    kt = random_ktensor_host(rng, modes, 3)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    queue = [random_ktensor_host(rng, modes, r) for r in (1, 2, 3, 4, 5, 3, 2)]
    jk = [-1, 3, -1, 0, -1, 7, -1]
    params = CalsParams(max_iterations=8, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4, 8))
    fm.fused_mttkrp_fp32.launches = fe.normal_inverse.launches = fe.epilogue_apply.launches = 0
    res_d, rep_d = cp_cals(x, queue, params, jk_fibers=jk)
    iters = sum(rep_d.engine_iterations.values())
    assert fm.fused_mttkrp_fp32.launches == fe.normal_inverse.launches == fe.epilogue_apply.launches == 3 * iters
    res_c, rep_c = cp_cals(x, queue, params, jk_fibers=jk, device="cpu")
    for a, b, ma, mb in zip(res_d, res_c, rep_d.models, rep_c.models):
        assert ma.iters == mb.iters
        assert abs(ma.fit - mb.fit) <= 1e-4
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_allclose(fa, fb, rtol=2e-3, atol=2e-3)


def _spd_batch(rng, b, r, cond):
    """SPD matrices with condition numbers spread up to ``cond``."""
    q, _ = np.linalg.qr(rng.normal(size=(b, r, r)))
    top = np.geomspace(1.0, cond, b)[:, None]
    s = top ** np.linspace(0.0, 1.0, r)[None, :]
    return np.einsum("bij,bj,bkj->bik", q, s, q)


@pytest.mark.parametrize("r", GJ_RANKS)
def test_spd_inverse_kernel_matches_plain(dev, r):
    rng = np.random.default_rng(r)
    # 41: not a multiple of 4 models per block; scaled, so that 2I - H is not
    # the inverse at R = 1 (where every H of _spd_batch is 1)
    h = (_spd_batch(rng, 41, r, 1e4) * np.geomspace(0.5, 4.0, 41)[:, None, None]).astype(np.float32)
    h[[3, 17]] = np.eye(r, dtype=np.float32)  # dead slots
    ht = torch.from_numpy(h).to(dev)
    before = si.spd_inverse.launches
    got = si.spd_inverse(ht)
    assert si.spd_inverse.launches == before + 1
    want = si.spd_inverse_plain(ht)
    _check_inverse(got, want, ht)
    eye = torch.eye(r, device=dev).expand(2, r, r)
    assert torch.equal(got[[3, 17]], eye)
    assert torch.equal(si.spd_inverse(ht[:1]), got[:1])
    assert si.spd_inverse(ht[:0]).shape == (0, r, r) and si.spd_inverse.launches == before + 2


def test_spd_inverse_rejects_what_it_does_not_take(dev):
    h = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError):
        si.spd_inverse(h.double())
    with pytest.raises(ValueError):
        si.spd_inverse(torch.eye(si.MAX_R + 1, device=dev).expand(2, si.MAX_R + 1, si.MAX_R + 1).contiguous())
    with pytest.raises(ValueError):
        si.spd_inverse(torch.zeros(2, 3, 4, device=dev))
    with pytest.raises(ValueError):
        si.spd_inverse(h.transpose(0, 2))


@pytest.mark.parametrize("shape", [probe.SMALL, probe.BIG, (7,), (0,)])
def test_probe_copy_kernel_is_exact(dev, shape):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(dev)
    assert torch.equal(probe.probe_copy(x), probe.probe_copy_plain(x))


def _als_problem(seed, rank=3):
    rng = np.random.default_rng(seed)
    modes = (20, 17, 9)
    kt = random_ktensor_host(rng, modes, rank)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    return x, rng, modes


def _reset():
    fm.fused_mttkrp_fp32.launches = fe.normal_inverse.launches = fe.epilogue_apply.launches = 0
    si.spd_inverse.launches = 0


def test_cp_batched_als_pallas_on_card_matches_cpu(dev):
    """The unfused epilogue through the SPD-inverse kernel: 3 launches per
    lock-step iteration, none of the fused epilogue kernels."""
    x, rng, modes = _als_problem(3)
    inits = [random_ktensor_host(rng, modes, 3) for _ in range(5)]
    params = AlsParams(max_iterations=15, force_max_iter=True, solve_method="pallas")
    _reset()
    res_d, reps_d = cp_batched_als(x, inits, params)
    assert si.spd_inverse.launches == fm.fused_mttkrp_fp32.launches == 3 * 15
    assert fe.normal_inverse.launches == fe.epilogue_apply.launches == 0
    res_c, reps_c = cp_batched_als(x, inits, params, device="cpu")
    for a, b, ra, rb in zip(res_d, res_c, reps_d, reps_c):
        assert abs(ra.fit - rb.fit) <= 1e-4
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_allclose(fa, fb, rtol=2e-3, atol=2e-3)
    # cp_als: one model as a batch of one, through the fused kernels.
    _reset()
    kt, rep = cp_als(x, inits[0], AlsParams(max_iterations=6, force_max_iter=True))
    assert fe.normal_inverse.launches == fe.epilogue_apply.launches == 3 * 6 and si.spd_inverse.launches == 0
    kc, rc = cp_als(x, inits[0], AlsParams(max_iterations=6, force_max_iter=True), device="cpu")
    assert abs(rep.fit - rc.fit) <= 1e-4


def test_jk_cp_cals_pallas_on_card_matches_cpu(dev):
    x, rng, modes = _als_problem(4)
    kt_fit, _ = cp_als(x, random_ktensor_host(rng, modes, 3), AlsParams(tol=1e-8, max_iterations=200))
    params = CalsParams(max_iterations=8, force_max_iter=True, bucket_ranks=(4,), solve_method="pallas")
    _reset()
    rep_d = jk_cp_cals(x, [kt_fit], params)
    bucket_iters = sum(rep_d.cals_report.engine_iterations.values())
    assert si.spd_inverse.launches == fm.fused_mttkrp_fp32.launches == 3 * bucket_iters > 0
    assert fe.normal_inverse.launches == fe.epilogue_apply.launches == 0
    rep_c = jk_cp_cals(x, [kt_fit], params, device="cpu")
    assert len(rep_d.results[0]) == modes[0]
    for a, b in zip(rep_d.results[0], rep_c.results[0]):
        for fa, fb in zip(a.factors, b.factors):
            mask = np.isfinite(fa)
            assert (mask == np.isfinite(fb)).all()
            np.testing.assert_allclose(fa[mask], fb[mask], rtol=2e-3, atol=2e-3)
