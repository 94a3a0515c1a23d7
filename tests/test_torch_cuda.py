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

import dataclasses

import numpy as np
import pytest
import torch

from cp_cals_tpu_torch import (
    AlsParams,
    CalsParams,
    LineSearchMethod,
    MttkrpMethod,
    UpdateMethod,
    cp_als,
    cp_batched_als,
    cp_cals,
    jk_cp_cals,
    random_ktensor_host,
    release_graphs,
)
from cp_cals_tpu_torch import launches
from cp_cals_tpu_torch import probe_overhead as probe
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops import mttkrp as mt
from cp_cals_tpu_torch.ops import spd_inverse as si
from cp_cals_tpu_torch.ops.gramians import gramians
from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches, bucket_rank
from cp_cals_tpu_torch.utils import lut

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _no_table(tmp_path_factory, monkeypatch):
    """Every test reads an empty table root and never autotunes, so AUTO is
    the heuristic, unless the test asks for the table
    (``test_autotune_*``)."""
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path_factory.mktemp("lookup_tables")))
    monkeypatch.setenv("CP_CALS_NO_AUTOTUNE", "1")


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


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_swept_plans_match_plain(dev, precision):
    """Every plan profiles/tune_pallas_mttkrp sweeps at this shape gives the
    plain version's result; the planner's own plan, passed explicitly, gives
    the planner's bits; an illegal plan raises before any launch."""
    from cp_cals_tpu_torch.profiles import tune_pallas_mttkrp as tune

    rng = np.random.default_rng(2)
    modes, b, r = (70, 45, 33), 5, 7
    x = torch.from_numpy(rng.normal(size=modes).astype(np.float32)).to(dev)
    fs = [torch.from_numpy(rng.normal(size=(b, m, r)).astype(np.float32)).to(dev) for m in modes]
    card = tune.card_of(dev)
    for mode in range(3):
        small, big = fm.split_others(modes, mode)
        held = fm.prepare_mode_tensor(x, mode, precision)
        want = fm.fused_mttkrp_plain(held, fs[small], fs[big], precision)
        scale = want.abs().max().item()
        planned = fm.mttkrp_batched_fused(x, fs, mode, held, precision)
        cases = [c for c in tune.sweep(modes, mode, b, r, precision, card) if "refused" not in c]
        assert cases[0]["planner"]
        for case in cases:
            got = fm.mttkrp_batched_fused(x, fs, mode, held, precision, plan=tuple(case["plan"]))
            assert (got - want).abs().max().item() <= 2e-5 * scale, case["name"]
            if case["planner"]:
                assert torch.equal(got, planned)
        before = launches.read()
        bad = (cases[0]["plan"][0], 8) + tuple(cases[0]["plan"][2:])  # k per block not whole stages
        with pytest.raises(ValueError, match="multiple of the stage"):
            fm.mttkrp_batched_fused(x, fs, mode, held, precision, plan=bad)
        assert launches.read() == before


def test_tc_smem_mirror_matches_the_built_kernel(dev):
    """The tensor-core kernel's shared memory as the planner computes it
    without a card (``tc_smem``) is the built kernel's own."""
    smem = fm._lib_tc().fused_mttkrp_tc_smem
    for nc in fm._TC_NC:
        for high in (0, 1):
            for kspan in range(64, 4097, 64):
                assert smem(nc, high, kspan) == fm.tc_smem(nc, high, kspan)


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
    for n in (2, fe.MAX_MODES + 1):  # the kernel takes 2 to MAX_MODES - 1 other gramians
        with pytest.raises(ValueError):
            fe.normal_inverse((eye,) * n, torch.ones(2, 3, dtype=torch.bool, device=dev), 0)
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


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 2048, 2049, 576 * 1024 + 1])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_probe_copy_kernel_is_exact_at_any_length_and_alignment(dev, n, offset):
    """Bit for bit x * 0.999 at lengths around the float4 and block edges,
    on offset views (x misaligned against a fresh output: the scalar path),
    and with x and the output misaligned alike (the float4 body between a
    scalar head and tail), launched directly."""
    from cp_cals_tpu_torch import _build

    base = torch.from_numpy(np.random.default_rng(n).normal(size=n + 8).astype(np.float32)).to(dev)
    x = base[offset : offset + n]
    assert torch.equal(probe.probe_copy(x), probe.probe_copy_plain(x))
    out = torch.full_like(base, float("nan"))
    o = out[offset : offset + n]
    code = probe._lib().probe_copy_launch(x.data_ptr(), o.data_ptr(), n, _build.stream_ptr(dev))
    assert code == 0
    torch.cuda.synchronize()
    assert torch.equal(o, probe.probe_copy_plain(x))
    assert torch.isnan(out[:offset]).all() and torch.isnan(out[offset + n :]).all()  # nothing outside


def _nonneg_problem(seed, ranks, modes=(20, 17, 9)):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, modes, 3)
    x = np.einsum("ir,jr,kr,r->ijk", *[np.abs(f) for f in kt.factors], np.abs(kt.lam))
    x = np.abs(x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    return x, [random_ktensor_host(rng, modes, r) for r in ranks]


NNLS_LS_CASES = {
    "bpp": dict(update_method=UpdateMethod.NNLS),
    "lawson_hanson": dict(update_method=UpdateMethod.NNLS, nnls_algorithm="lawson_hanson"),
    "nec": dict(line_search=True, line_search_interval=3),
    "ec": dict(line_search=True, line_search_interval=3, line_search_method=LineSearchMethod.ERROR_CHECKING),
    "bpp_nec": dict(update_method=UpdateMethod.NNLS, line_search=True, line_search_interval=3),
}


@pytest.mark.parametrize("case", sorted(NNLS_LS_CASES))
def test_nnls_and_line_search_under_capture(dev, case):
    """NNLS and both line searches in the captured graph loop: bit for bit
    the eager iter loop on the card, the kernels' launches exact (ERROR_CHECKING's
    candidate MTTKRP predicated once per bucket-iteration), and against the
    same fp32 run on the CPU (force_max_iter: equal iterations, fits at
    1e-4, factors >= 0 under NNLS)."""
    x, queue = _nonneg_problem(11, (2, 3, 4, 3, 2, 4, 1))
    params = CalsParams(max_iterations=9, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4),
                        tail_compaction_depth=0, **NNLS_LS_CASES[case])
    nnls = params.update_method == UpdateMethod.NNLS
    runs = {}
    for mode in ("iter", "evict"):
        _zero()
        runs[mode] = cp_cals(x, queue, dataclasses.replace(params, sync_mode=mode))
        counts = _counts()
        steps = sum(runs[mode][1].engine_iterations.values())
        epilogue = 0 if nnls else 3 * steps
        want = dict(fused_mttkrp_fp32=3 * steps, normal_inverse=epilogue, epilogue_apply=epilogue)
        if case == "ec":
            want["fused_mttkrp_fp32.predicated"] = steps
        assert counts == {k: want.get(k, 0) for k in counts}, (mode, counts)
    (res_i, rep_i), (res_g, rep_g) = runs["iter"], runs["evict"]
    assert sum(c["replays"] for c in rep_g.loop_counts.values()) > 0
    for a, b, ma, mb in zip(res_i, res_g, rep_i.models, rep_g.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)
    res_c, rep_c = cp_cals(x, queue, params, device="cpu")
    for a, b, ma, mb in zip(res_g, res_c, rep_g.models, rep_c.models):
        assert ma.iters == mb.iters
        assert abs(ma.fit - mb.fit) <= 1e-4
        if nnls:
            assert min(float(f.min()) for f in a.factors) >= 0.0


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


# ------------------------------------------------------------ predicated MTTKRP


def _raw_launch(x3, u1, u2, precision, pred, out):
    """The wrapper's launch with a caller's output (prefilled), so that a
    test sees what an off predicate leaves unwritten."""
    from cp_cals_tpu_torch import _build

    dev = x3.device
    b, j, r = u1.shape
    k = u2.shape[1]
    index = torch.cuda.current_device()
    stream = _build.stream_ptr(dev)
    if precision == "highest":
        jj, kk, i = x3.shape
        plan = fm.fp32_plan(index, jj, i, kk, b * r)
        work = torch.full((plan[2] * plan[3], i, b * r), float("nan"), device=dev)
        code = fm._lib_fp32().fused_mttkrp_launch(
            x3.data_ptr(), u1.data_ptr(), u2.data_ptr(), out.data_ptr(), work.data_ptr(),
            jj, i, x3.stride(1), kk, b, r, *plan, pred.data_ptr(), stream)
    else:
        planes = fm.PLANES[precision]
        i, kp = x3.shape[-2], x3.shape[-1]
        plan = fm.tc_plan(index, j, i, kp, b * r, planes)
        work = torch.full((plan[2] * plan[3], i, b * r), float("nan"), device=dev)
        code = fm._lib_tc().fused_mttkrp_tc_launch(
            x3.data_ptr(), u1.data_ptr(), u2.data_ptr(), out.data_ptr(), work.data_ptr(),
            j, i, k, kp, b, r, planes - 1, *plan, pred.data_ptr(), stream)
    _build.check(code, "predicated launch")
    torch.cuda.synchronize()
    return plan


PRED_CASES = [("highest", c) for c in ((41, 301, 299, 12, 8), (299, 3001, 3, 6, 5), (20, 30, 1, 1, 3))] + [
    (p, c) for p in ("default", "high") for c in ((41, 301, 299, 12, 8), (70, 3001, 3, 6, 5), (20, 30, 1, 1, 3),
                                                  (299, 301, 41, 96, 20))]  # the last: j split over two waves


@pytest.mark.parametrize("precision,case", PRED_CASES)
def test_predicated_mttkrp(dev, precision, case):
    """A predicate of 0 leaves the output (and the split workspace's sum)
    unwritten and counts one predicated launch; a predicate of 1 gives the
    unpredicated kernel's result bit for bit. The cases include j and k
    splits, so the split reduction is predicated too."""
    i, k, j, b, r = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(size=(i, k, j)).astype(np.float32)).to(dev)
    u1 = torch.from_numpy(rng.normal(size=(b, j, r)).astype(np.float32)).to(dev)
    u2 = torch.from_numpy(rng.normal(size=(b, k, r)).astype(np.float32)).to(dev)
    x3 = fm.prepare_mode_tensor(x, 0, precision)
    want = fm.fused_mttkrp(x3, u1, u2, precision)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    on = torch.ones(1, dtype=torch.int32, device=dev)
    out = torch.full((b, i, r), float("nan"), device=dev)
    _raw_launch(x3, u1, u2, precision, off, out)
    assert torch.isnan(out).all()
    _raw_launch(x3, u1, u2, precision, on, out)
    assert torch.equal(out, want)
    kernel = fm.fused_mttkrp_fp32 if precision == "highest" else fm.fused_mttkrp_tc
    before = (kernel.launches, kernel.predicated)
    got = fm.fused_mttkrp(x3, u1, u2, precision, pred=on)
    fm.fused_mttkrp(x3, u1, u2, precision, pred=off)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (kernel.launches, kernel.predicated) == (before[0], before[1] + 2)
    with pytest.raises(ValueError):
        fm.fused_mttkrp(x3, u1, u2, precision, pred=on.to(torch.int64))


# ------------------------------------- the tensor-core MTTKRP over several waves

# (tensor modes, B, R, target mode): launches the planner splits over more
# than one wave (tests/test_torch_tc_schedule.py): 299x301x41 at 1,920 and
# 6,400 columns, and cube500's bucket 20 (64 x 20 at 500^3).
WAVES_CASES = [((299, 301, 41), 96, 20, 0), ((299, 301, 41), 320, 20, 2),
               ((500, 500, 500), 64, 20, 0), ((500, 500, 500), 64, 20, 2)]


def _waves_problem(dev, modes, b, r, mode, precision):
    """X's held layout and the factors of ``mode``, and the planner's plan,
    which splits j over more than one wave of the card's block slots."""
    rng = np.random.default_rng(sum(modes) + b * r + mode)
    x = torch.from_numpy(rng.normal(size=modes).astype(np.float32)).to(dev)
    fs = [torch.from_numpy(rng.normal(size=(b, m, r)).astype(np.float32)).to(dev) for m in modes]
    small, big = fm.split_others(modes, mode)
    x3 = fm.prepare_mode_tensor(x, mode, precision)
    j, i, kp = modes[small], modes[mode], x3.shape[-1]
    index, planes = torch.cuda.current_device(), fm.PLANES[precision]
    plan = fm.tc_plan(index, j, i, kp, b * r, planes)
    slots = fm._tc_slots(index, plan[0], planes, plan[1])
    assert plan[3] > 1 and fm.tc_waves(plan, i, b * r, slots) > 1, plan
    assert plan != fm.one_wave_tc(plan[:3], j, i, b * r, slots)
    return x3, fs[small], fs[big], plan


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("modes,b,r,mode", WAVES_CASES)
def test_several_waves_match_plain_and_relaunch_bit_for_bit(dev, precision, modes, b, r, mode):
    """The planner's launch over several waves against the plain version
    at 2e-5 * max|G|; a second launch, and the plan passed explicitly, give
    the same bits."""
    x3, u1, u2, plan = _waves_problem(dev, modes, b, r, mode, precision)
    got = fm.fused_mttkrp_tc(x3, u1, u2, precision)
    again = fm.fused_mttkrp_tc(x3, u1, u2, precision)
    given = fm.fused_mttkrp_tc(x3, u1, u2, precision, plan=plan)
    want = fm.fused_mttkrp_plain(x3, u1, u2, precision)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    assert torch.equal(got, again) and torch.equal(got, given)


def test_several_waves_under_capture_count_at_replay(dev):
    """Captured beside a one-wave launch, the launch over several waves
    replays the eager bits; each replay adds both to the wrapper's launch
    count and the one over several waves to ``mttkrp.tc_balanced``, which
    the capture itself did not count; an eager launch counts at once."""
    from cp_cals_tpu_torch.solvers.graph_loop import Graph
    from cp_cals_tpu_torch.utils import timers

    x3, u1, u2, plan = _waves_problem(dev, (299, 301, 41), 96, 20, 0, "high")
    wave = plan[:3] + (1, u1.shape[1])
    eager = (fm.fused_mttkrp_tc(x3, u1, u2, "high"), fm.fused_mttkrp_tc(x3, u1, u2, "high", plan=wave))
    box = {}
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))

    def body():
        box["out"] = (fm.fused_mttkrp_tc(x3, u1, u2, "high"), fm.fused_mttkrp_tc(x3, u1, u2, "high", plan=wave))

    with timers.recording():
        with torch.cuda.stream(stream):
            graph = Graph(body)
            captured = timers.counters()
            before = fm.fused_mttkrp_tc.launches
            graph.replay(3)
        stream.synchronize()
        replayed, launched = timers.counters(), fm.fused_mttkrp_tc.launches - before
        fm.fused_mttkrp_tc(x3, u1, u2, "high")
        eager_counts = timers.counters()
    assert "mttkrp.tc_balanced" not in captured
    assert (replayed["mttkrp.tc_balanced"], launched) == (3, 6)
    assert eager_counts["mttkrp.tc_balanced"] == 4
    assert torch.equal(box["out"][0], eager[0]) and torch.equal(box["out"][1], eager[1])


# ------------------------------------------------------------ the engine loops


def _bench_problem(seed, per_rank):
    """The bench tensor's shape (299 x 301 x 41), ranks 1-20 with a few
    models each."""
    rng = np.random.default_rng(seed)
    modes = (299, 301, 41)
    kt = random_ktensor_host(rng, modes, 5)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.05 * x.std() * rng.standard_normal(modes)).astype(np.float32)
    return x, [random_ktensor_host(rng, modes, r) for r in range(1, 21) for _ in range(per_rank)]


_counts, _zero = launches.read, launches.reset


@pytest.mark.parametrize("tiers", [{}, dict(precision="high", mttkrp_precision="default")],
                         ids=["highest", "bench_tiers"])
def test_graph_loop_matches_the_iter_loop(dev, tiers):
    """The captured loop against sync_mode="iter" at the bench shapes, cut
    to 3 models per rank (buckets 4-20 of 12-16 slots, refills): every
    model's fit, iterations and factors bit for bit, and the launch counts
    exact with the replays."""
    x, queue = _bench_problem(3, 3)
    base = CalsParams(max_iterations=6, force_max_iter=True, bucket_ranks=(4, 8, 12, 16, 20), buffer_size=600,
                      tail_compaction_depth=0, **tiers)
    kernel = "fused_mttkrp_tc" if tiers else "fused_mttkrp_fp32"
    runs = {}
    for mode in ("iter", "evict"):
        release_graphs()  # each run captures its own graphs
        _zero()
        runs[mode] = cp_cals(x, queue, dataclasses.replace(base, sync_mode=mode))
        counts = _counts()
        steps = sum(runs[mode][1].engine_iterations.values())
        assert counts == {k: (3 * steps if k in (kernel, "normal_inverse", "epilogue_apply") else 0)
                          for k in counts}
    (res_i, rep_i), (res_g, rep_g) = runs["iter"], runs["evict"]
    assert rep_g.engine_iterations == rep_i.engine_iterations
    assert sum(c["captures"] for c in rep_g.loop_counts.values()) == len(rep_g.loop_counts)
    assert sum(c["replays"] for c in rep_g.loop_counts.values()) > 0
    for a, b, ma, mb in zip(res_i, res_g, rep_i.models, rep_g.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


THREAD_CASES = {
    "forced-highest": dict(max_iterations=6, force_max_iter=True, tail_compaction_depth=2),
    "forced-bench-tiers": dict(max_iterations=6, force_max_iter=True, precision="high", mttkrp_precision="default"),
    "tol-checks-polish": dict(tol=1e-5, max_iterations=30, precision="high", mttkrp_precision="default",
                              tol_check_interval=5, polish_iters=2),
}


@pytest.mark.parametrize("case", sorted(THREAD_CASES))
def test_threaded_buckets_match_serial_bit_for_bit(dev, case):
    """bucket_threads=4 (each bucket on its own stream, captured while other
    buckets run) against 1, in turns: every model's fit, iterations and
    factors bit for bit, the launch counts and routes equal, and each
    bucket's captures, replays and stats fetches."""
    x, queue = _bench_problem(4, 3)
    base = CalsParams(bucket_ranks=(4, 8, 12, 16, 20), buffer_size=600, **THREAD_CASES[case])
    runs = []
    for t in (1, 4, 4, 1):
        release_graphs()  # each run captures its own graphs
        _zero()
        res, rep = cp_cals(x, queue, dataclasses.replace(base, bucket_threads=t))
        runs.append((res, rep, _counts(), launches.routes()))
    res1, rep1, counts1, routes1 = runs[0]
    assert len(rep1.engine_iterations) == 5 and counts1["normal_inverse"] > 0
    for res, rep, counts, routes in runs[1:]:
        assert (counts, routes) == (counts1, routes1)
        assert rep.engine_iterations == rep1.engine_iterations
        assert {r: {k: c[k] for k in ("captures", "replays", "stats_fetches", "polish_sweeps")}
                for r, c in rep.loop_counts.items()} == \
            {r: {k: c[k] for k in ("captures", "replays", "stats_fetches", "polish_sweeps")}
             for r, c in rep1.loop_counts.items()}
        for a, b, ma, mb in zip(res1, res, rep1.models, rep.models):
            assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
            for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
                np.testing.assert_array_equal(fa, fb)


def test_concurrent_calls_wait_for_the_bucket_streams(dev):
    """Two cp_cals calls from two threads at once (4 bucket threads each):
    the second waits for the device's bucket streams, and each equals a
    lone call bit for bit, their launch counts twice the lone call's."""
    import threading

    x, queue = _bench_problem(4, 2)
    params = CalsParams(bucket_ranks=(4, 8, 12, 16, 20), buffer_size=600, bucket_threads=4,
                        **THREAD_CASES["forced-bench-tiers"])
    _zero()
    lone, _ = cp_cals(x, queue, params)
    counts = _counts()
    _zero()
    outs = [None, None]

    def call(i):
        outs[i] = cp_cals(x, queue, params)[0]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _counts() == {k: 2 * n for k, n in counts.items()}
    for res in outs:
        for a, b in zip(lone, res):
            for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
                np.testing.assert_array_equal(fa, fb)


GRAPH_CACHE_CASES = {
    "forced-bench-tiers": THREAD_CASES["forced-bench-tiers"],
    "jk-tol-polish-compaction": dict(tol=1e-6, max_iterations=40, tol_check_interval=5, polish_iters=25,
                                     polish_tol=1e-6, evict_batch=2, precision="high", mttkrp_precision="default",
                                     bucket_ranks=(8,), buffer_size=2400),
    "threads-4": dict(THREAD_CASES["forced-bench-tiers"], bucket_threads=4),
}


def _engine_call(case, x, queue, kt):
    """One run of a GRAPH_CACHE_CASES case from counts at 0: (results,
    report, launch counts, routes)."""
    _zero()
    kw = GRAPH_CACHE_CASES[case]
    if case.startswith("jk"):
        rep = jk_cp_cals(x, [kt], CalsParams(**kw))
        res, rep = rep.results[0], rep.cals_report
    else:
        res, rep = cp_cals(x, queue, CalsParams(bucket_ranks=(4, 8, 12, 16, 20), buffer_size=600, **kw))
    return res, rep, _counts(), launches.routes()


def _assert_runs_equal(a, b):
    (res_a, rep_a, counts_a, routes_a), (res_b, rep_b, counts_b, routes_b) = a, b
    assert (counts_a, routes_a) == (counts_b, routes_b)
    assert rep_a.engine_iterations == rep_b.engine_iterations
    assert [(m.id, m.iters, m.fit, m.approx_error) for m in rep_a.models] == \
        [(m.id, m.iters, m.fit, m.approx_error) for m in rep_b.models]
    for a_, b_ in zip(res_a, res_b):
        for fa, fb in zip(a_.factors + (a_.lam,), b_.factors + (b_.lam,)):
            np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("case", sorted(GRAPH_CACHE_CASES))
def test_a_second_call_replays_kept_graphs_bit_for_bit(dev, case):
    """A second call of the same shapes and params takes the graphs the
    first kept (and captures none where every bucket finds its stream's)
    and is bit for bit the call after a release: every model's iterations,
    fit, error, factors and lam, and the launch counts and routes. The
    jackknife case is tol-driven, polished and tail-compacted."""
    x, queue = _bench_problem(5, 2)
    kt = random_ktensor_host(np.random.default_rng(6), x.shape, 5)
    release_graphs()
    fresh = _engine_call(case, x, queue, kt)
    second = _engine_call(case, x, queue, kt)
    _assert_runs_equal(fresh, second)
    (cap0, reuse0), (cap1, reuse1) = [[sum(c[k] for c in run[1].loop_counts.values())
                                       for k in ("captures", "graph_reuses")] for run in (fresh, second)]
    assert cap0 > 0 and reuse0 == 0 and reuse1 > 0, (cap0, reuse0, cap1, reuse1)
    if case != "threads-4":  # four threads may put a bucket on another stream than last time
        assert cap1 == 0 and reuse1 == cap0, (cap0, reuse0, cap1, reuse1)
    if case.startswith("jk"):
        assert len({b for g in _kept_slots() for (b, _), *_ in g.loops}) >= 2  # a compacted loop's entry
    release_graphs()
    _assert_runs_equal(fresh, _engine_call(case, x, queue, kt))


def _kept_slots():
    from cp_cals_tpu_torch.solvers import cals

    return [g for _, _, cache in cals._STREAMS.values() for g in cache.slots]


def test_a_new_x_or_one_written_in_place_gives_a_fresh_calls_results(dev):
    """The kept graphs read the kept copy of X and its layouts: another X of
    the same shape, and the caller's X written in place between calls, each
    give the results of a call after a release."""
    x, queue = _bench_problem(7, 1)
    other, _ = _bench_problem(8, 1)
    params = CalsParams(bucket_ranks=(4, 8, 12, 16, 20), buffer_size=600, **GRAPH_CACHE_CASES["forced-bench-tiers"])
    xt = torch.from_numpy(x).to(dev)
    for second in (lambda: torch.from_numpy(other).to(dev), lambda: xt.mul_(0.5)):
        release_graphs()
        cp_cals(xt, queue, params)
        x2 = second()
        _zero()
        res, rep = cp_cals(x2, queue, params)
        got = (res, rep, _counts(), launches.routes())
        assert sum(c["captures"] for c in rep.loop_counts.values()) == 0
        release_graphs()
        _zero()
        res, rep = cp_cals(x2, queue, params)
        _assert_runs_equal(got, (res, rep, _counts(), launches.routes()))


def test_precompile_buckets_leaves_no_autotune_to_cp_cals(dev, monkeypatch):
    """precompile_buckets on an empty table autotunes every bucket's
    entries; a second call and the engine then hit them exactly and tune
    nothing."""
    from cp_cals_tpu_torch.solvers.cals import precompile_buckets

    monkeypatch.delenv("CP_CALS_NO_AUTOTUNE")
    x, queue = _bench_problem(6, 1)
    params = CalsParams(max_iterations=3, force_max_iter=True, bucket_ranks=(4, 8, 12, 16, 20), buffer_size=200,
                        precision="high", mttkrp_precision="default")
    precompile_buckets(x, queue, params)

    def refuse(*a, **k):
        raise AssertionError("autotune after precompile_buckets")

    monkeypatch.setattr(lut, "autotune", refuse)
    precompile_buckets(x, queue, params)
    lut.reset_lookup_stats()
    _, rep = cp_cals(x, queue, params)
    assert lut.LOOKUP_STATS == {"exact": 3 * len(rep.engine_iterations), "nearest": 0, "heuristic": 0}


def test_graph_loop_with_checks_and_polish_matches_cpu(dev):
    """The fast tier's mixed-tier check and polish through the graph loop
    (tol-driven, refills): iterations within one check window of the CPU
    run's and fits at 1e-4; one predicated launch per bucket-iteration."""
    x, rng, modes = _als_problem(5, rank=4)
    queue = [random_ktensor_host(rng, modes, r) for r in (2, 3, 4, 3, 2, 4, 3)]
    params = CalsParams(tol=1e-6, max_iterations=60, bucket_ranks=(4,), buffer_size=12, precision="high",
                        mttkrp_precision="default", tol_check_interval=3, polish_iters=6, polish_tol=1e-6,
                        evict_batch=2)
    _zero()
    res_d, rep_d = cp_cals(x, queue, params)
    counts = _counts()
    steps = sum(rep_d.engine_iterations.values())
    sweeps = sum(c["polish_sweeps"] for c in rep_d.loop_counts.values())
    assert sweeps > 0
    assert counts["fused_mttkrp_tc"] == counts["normal_inverse"] == 3 * (steps + sweeps)
    assert counts["fused_mttkrp_tc.predicated"] == steps
    res_c, rep_c = cp_cals(x, queue, params, device="cpu")
    for a, b, ma, mb in zip(res_d, res_c, rep_d.models, rep_c.models):
        assert abs(ma.iters - mb.iters) <= 3
        assert abs(ma.fit - mb.fit) <= 1e-4


@pytest.mark.parametrize("modes,rank,data_rank", [((3000, 64, 48), 20, 24), ((90, 80, 70), 65, 70)],
                         ids=["I3000_R20", "R65"])
def test_cp_cals_beyond_the_fused_epilogue(dev, modes, rank, data_rank):
    """Modes the fused epilogue cannot take (shared memory at I = 3,000 and
    R = 20; R = 65 above its MAX_R, bucket 128) go through the unfused path
    mode by mode, where the default cp_cals used to raise; against the same
    run on the CPU at this file's tolerances. The models fit data of a
    higher rank (24, 70), so that their factors are determined and the
    two summation orders stay within those tolerances."""
    rng = np.random.default_rng(rank)
    kt = random_ktensor_host(rng, modes, data_rank)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    queue = [random_ktensor_host(rng, modes, r) for r in (rank, rank - 1, 3)]
    params = CalsParams(max_iterations=5, force_max_iter=True)
    _zero()
    res_d, rep_d = cp_cals(x, queue, params)
    res_c, rep_c = cp_cals(x, queue, params, device="cpu")
    for a, b, ma, mb in zip(res_d, res_c, rep_d.models, rep_c.models):
        assert ma.iters == mb.iters == 5
        assert abs(ma.fit - mb.fit) <= 1e-4
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_allclose(fa, fb, rtol=2e-3, atol=2e-3)
    assert not fe.supports_fused_epilogue(1, 3000, 20, torch.float32, 3, dev)
    assert not fe.supports_fused_epilogue(1, 90, 65, torch.float32, 3, dev)
    assert fe.supports_fused_epilogue(1, 299, 20, torch.float32, 3, dev)


# ------------------------------------- N-D tensors and the widened epilogue


@pytest.mark.parametrize("k", [2, 3, 4, 7])
@pytest.mark.parametrize("r", [1, 5, 20, 33])
def test_epilogue_kernels_with_k_gramians_match_plain(dev, r, k):
    """The normal inverse and the apply's FastALS error with K = N - 1
    other-mode gramians (the pointers passed by value), against their plain
    versions; K = 2 is the 3-D case."""
    rng = np.random.default_rng(10 * k + r)
    b, n = 7, k + 1
    modes = tuple(2 * r + 3 + q for q in range(n))
    mask = np.broadcast_to(np.arange(r) < max(1, r - 1), (b, r)).copy()
    mask[-1] = False
    m = torch.from_numpy(mask).to(dev)
    factors = [torch.from_numpy(rng.normal(size=(b, i, r)).astype(np.float32)).to(dev) * m[:, None, :]
               for i in modes]
    factors = [f / f.norm(dim=1, keepdim=True).clamp(min=1e-30) for f in factors]
    grams = gramians(factors)
    for skip in (0, n - 1):
        got = fe.normal_inverse(grams, m, skip)
        want = fe.normal_inverse_plain(grams, m, skip)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    hinv = fe.normal_inverse(grams, m, n - 1)
    g = torch.from_numpy(rng.normal(size=(b, modes[-1], r)).astype(np.float32)).to(dev) * m[:, None, :]
    jk = torch.full((b,), -1, dtype=torch.int32, device=dev)
    iters = torch.full((b,), 3, dtype=torch.int32, device=dev)
    err_inputs = (torch.linspace(20.0, 30.0, b, device=dev), *grams[:-1])
    got = fe.epilogue_apply(g, hinv, iters, jk, False, err_inputs)
    want = fe.epilogue_apply_plain(g, hinv, iters, jk, False, err_inputs)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


def test_widened_kernels_take_the_gramians_the_python_side_allows(dev):
    assert fe._lib().hinv_max_grams() == fe.MAX_MODES - 1
    assert fe.supports_fused_epilogue(8, 299, 20, torch.float32, fe.MAX_MODES, dev)
    assert not fe.supports_fused_epilogue(8, 299, 20, torch.float32, fe.MAX_MODES + 1, dev)
    assert not fe.supports_fused_epilogue(8, 299, 20, torch.float32, 2, dev)


def test_fused_mttkrp_gate_on_the_card(dev):
    assert all(fm.fused_mttkrp_supported((299, 301, 41), n, 80, 20, torch.float32, dev) for n in range(3))
    assert not fm.fused_mttkrp_supported((299, 301, 41), 0, 80, 20, torch.float64, dev)
    assert not fm.fused_mttkrp_supported((30, 20, 10, 8), 0, 8, 4, torch.float32, dev)
    assert not fm.fused_mttkrp_supported((5_000_000, 3, 2), 0, 1, 4, torch.float32, dev)  # row tiles > 65535


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tier_matmul_on_the_card_matches_the_emulation(dev, precision):
    """cuBLAS bf16 GEMMs with float32 output against the CPU's exact
    products of the rounded values: summation order only."""
    rng = np.random.default_rng(4)
    for sa, sb in (((300, 301), (301, 96)), ((96, 41, 29), (96, 29, 1))):
        a = torch.from_numpy(rng.normal(size=sa).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=sb).astype(np.float32))
        want = mt.tier_matmul(a.double(), b.double(), precision)
        got = mt.tier_matmul(a.to(dev), b.to(dev), precision)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double().cpu(), want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        if precision == "default":
            c = mt.tier_matmul(a.to(dev), b.to(dev), precision, torch.bfloat16)
            assert c.dtype == torch.bfloat16
            torch.testing.assert_close(c.double().cpu(), want, rtol=2 ** -7, atol=2 ** -7 * want.abs().max().item())


@pytest.mark.parametrize("method", ["twostep", "krp_gemm"])
@pytest.mark.parametrize("modes", [(30, 20, 10), (12, 10, 6, 5)])
def test_mttkrp_methods_on_the_card_match_cpu(dev, modes, method):
    rng = np.random.default_rng(len(modes))
    x = torch.from_numpy(rng.normal(size=modes).astype(np.float32))
    factors = [torch.from_numpy(rng.normal(size=(4, m, 3)).astype(np.float32)) for m in modes]
    for tier in ("highest", "high", "default"):
        for n in range(len(modes)):
            want = mt.mttkrp_batched(x.double(), [f.double() for f in factors], n, method, tier)
            got = mt.mttkrp_batched(x.to(dev), [f.to(dev) for f in factors], n, method, tier)
            torch.testing.assert_close(got.double().cpu(), want, rtol=2e-2 if tier == "default" else 1e-5,
                                       atol=(2e-2 if tier == "default" else 1e-5) * want.abs().max().item())


def test_cp_cals_4d_on_card_matches_cpu(dev):
    """A 4-D queue on the card: every mode through the twostep and every
    epilogue through the widened kernels (K = 3), against the CPU run."""
    rng = np.random.default_rng(8)
    modes = (20, 17, 9, 6)
    kt = random_ktensor_host(rng, modes, 3)
    x = np.einsum("ir,jr,kr,lr,r->ijkl", *kt.factors, kt.lam)
    x = (x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    queue = [random_ktensor_host(rng, modes, r) for r in (1, 2, 3, 4, 5, 3, 2)]
    jk = [-1, 3, -1, 0, -1, 7, -1]
    params = CalsParams(max_iterations=8, force_max_iter=True, buffer_size=12, bucket_ranks=(2, 4, 8))
    _zero()
    res_d, rep_d = cp_cals(x, queue, params, jk_fibers=jk)
    steps = sum(rep_d.engine_iterations.values())
    counts, routes = _counts(), launches.routes()
    assert counts["normal_inverse"] == counts["epilogue_apply"] == 4 * steps
    assert counts["fused_mttkrp_fp32"] == counts["fused_mttkrp_tc"] == 0
    assert routes == {"fused": 0, "twostep": 4 * steps, "krp_gemm": 0, "dimtree": 0}
    res_c, rep_c = cp_cals(x, queue, params, jk_fibers=jk, device="cpu")
    for a, b, ma, mb in zip(res_d, res_c, rep_d.models, rep_c.models):
        assert ma.iters == mb.iters
        assert abs(ma.fit - mb.fit) <= 1e-4
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_allclose(fa, fb, rtol=2e-3, atol=2e-3)


def test_float64_on_the_card_takes_the_twostep_and_the_unfused_path(dev):
    """The gates send float64 to the twostep and the unfused epilogue (no
    kernel launches) and the run equals the CPU's at float64 rounding."""
    rng = np.random.default_rng(9)
    modes = (14, 11, 9)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(modes)
    queue = [random_ktensor_host(rng, modes, r, dtype=np.float64) for r in (1, 2, 3, 2)]
    params = CalsParams(max_iterations=10, force_max_iter=True, buffer_size=8, bucket_ranks=(2, 4))
    _zero()
    res_d, rep_d = cp_cals(x, queue, params)
    assert all(v == 0 for v in _counts().values())
    assert launches.routes()["twostep"] == 3 * sum(rep_d.engine_iterations.values())
    res_c, rep_c = cp_cals(x, queue, params, device="cpu")
    for a, b, ma, mb in zip(res_d, res_c, rep_d.models, rep_c.models):
        assert ma.iters == mb.iters and abs(ma.fit - mb.fit) <= 1e-10
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_allclose(fa, fb, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kw", [dict(mttkrp_method=MttkrpMethod.TWOSTEP), dict(dimtree="on"),
                                dict(precision="high", mttkrp_precision="default", tol_check_interval=3,
                                     polish_iters=2)], ids=["twostep", "dimtree", "checks_polish"])
def test_recompute_equals_materialized_on_the_card(dev, kw):
    """Layouts derived inside the captured iteration give the held layouts'
    bits."""
    x, queue = _bench_problem(5, 1)
    base = dict(max_iterations=5, tol=1e-6, bucket_ranks=(4, 8, 12, 16, 20), buffer_size=200, **kw)
    if "tol_check_interval" not in kw:
        base["force_max_iter"] = True
    runs = [cp_cals(x, queue, CalsParams(mode_layouts=lay, **base)) for lay in ("materialized", "recompute")]
    (res_a, rep_a), (res_b, rep_b) = runs
    for a, b, ma, mb in zip(res_a, res_b, rep_a.models, rep_b.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


def test_auto_recompute_replays_its_kept_graphs_and_counts_its_layouts(dev, monkeypatch):
    """The ``cube500.select50_high`` cell's old path at 160^3: with the
    card's layout share lowered, ``mode_layouts="auto"`` derives every
    layout inside the captured graphs. A second call replays the kept graphs
    (``graphs.reused`` > 0, no capture); both calls' fits, factors and lam
    equal a "materialized" run's bit for bit; and the derived-layout
    counters read the same on replay as on capture: three hi/lo layouts,
    [2, 160, 160, 160] bf16, per bucket-iteration."""
    from cp_cals_tpu_torch import config
    from cp_cals_tpu_torch.utils import timers

    monkeypatch.setattr(config, "LAYOUT_CARD_SHARE", 1e-6)  # a budget of about 85 kB
    rng = np.random.default_rng(22)
    modes = (160, 160, 160)
    kt = random_ktensor_host(rng, modes, 5)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.05 * x.std() * rng.standard_normal(modes)).astype(np.float32)
    queue = [random_ktensor_host(rng, modes, r) for r in range(1, 21) for _ in range(2)]
    params = CalsParams(tol=1e-6, max_iterations=10, force_max_iter=True, precision="high",
                        bucket_ranks=(4, 8, 16, 20), buffer_size=384)
    assert config.resolve_layouts(params, torch.from_numpy(x), dev) == "recompute"
    release_graphs()
    runs = []
    for _ in range(2):
        with timers.recording():
            res, rep = cp_cals(x, queue, params)
        runs.append((res, rep, timers.counters()))
    release_graphs()
    res_m, rep_m = cp_cals(x, queue, dataclasses.replace(params, mode_layouts="materialized"))
    release_graphs()
    (_, rep0, c0), (_, rep1, c1) = runs
    caps = [sum(c[k] for c in rep.loop_counts.values()) for rep in (rep0, rep1) for k in ("captures", "graph_reuses")]
    assert caps[0] > 0 and caps[1] == 0 and caps[2] == 0 and caps[3] > 0, caps
    iters = sum(rep0.engine_iterations.values())
    assert iters == sum(rep1.engine_iterations.values())
    for c in (c0, c1):
        assert c["layouts.derived"] == 3 * iters, c
        assert c["layouts.derived_bytes"] == 3 * 2 * 160**3 * 2 * iters, c
        assert "layouts.held_bytes" not in c
    for res, rep, _ in runs:
        assert [(m.id, m.iters, m.fit, m.approx_error) for m in rep.models] == \
            [(m.id, m.iters, m.fit, m.approx_error) for m in rep_m.models]
        for a, b in zip(res, res_m):
            for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
                np.testing.assert_array_equal(fa, fb)


def test_auto_holds_layouts_above_128_mb_on_the_card(dev):
    """A 143.7 MB tensor (330^3 float32) at "high": above the JAX package's
    128 MB, but its three hi/lo layouts fit a quarter of the card, so
    ``mode_layouts="auto"`` holds them. They are built once
    (``layouts.held_bytes`` the reckoned bytes), none is derived, and the
    fits, factors and lam equal an explicit "recompute" run's bit for
    bit."""
    from cp_cals_tpu_torch import config
    from cp_cals_tpu_torch.utils import timers

    rng = np.random.default_rng(23)
    modes = (330, 330, 330)
    kt = random_ktensor_host(rng, modes, 5)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.05 * x.std() * rng.standard_normal(modes)).astype(np.float32)
    assert x.nbytes > config.LAYOUT_RECOMPUTE_BYTES
    queue = [random_ktensor_host(rng, modes, r) for r in range(1, 9) for _ in range(2)]
    params = CalsParams(tol=1e-6, max_iterations=5, force_max_iter=True, precision="high",
                        mttkrp_method=MttkrpMethod.PALLAS, bucket_ranks=(4, 8), buffer_size=64)
    assert config.resolve_layouts(params, torch.empty(modes, device="meta"), dev) == "materialized"
    release_graphs()
    with timers.recording():
        res_a, rep_a = cp_cals(x, queue, params)
    counts = timers.counters()
    release_graphs()
    res_r, rep_r = cp_cals(x, queue, dataclasses.replace(params, mode_layouts="recompute"))
    release_graphs()
    assert counts["layouts.held_bytes"] == config.held_layout_bytes(params, modes, 4) == 3 * 2 * 330 * 330 * 336 * 2
    assert "layouts.derived" not in counts and "layouts.derived_bytes" not in counts
    assert [(m.id, m.iters, m.fit, m.approx_error) for m in rep_a.models] == \
        [(m.id, m.iters, m.fit, m.approx_error) for m in rep_r.models]
    for a, b in zip(res_a, res_r):
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_autotune_on_the_card_writes_valid_entries(dev, precision):
    """Every mode gets a method its gate takes, each candidate a finite
    replayed time; the launch counts are left as they were; a second call
    hits the entries exactly."""
    modes, r, b = (64, 50, 30), 4, 8
    before = (launches.read(), launches.routes())
    got = lut.autotune(modes, r, b, reps=2, precision=precision, device=dev)
    assert (launches.read(), launches.routes()) == before
    table = lut._load(modes, dev)
    for n, m in enumerate(got):
        assert table[lut._key(b, r, n, precision)] == m and m in lut.METHODS
        times = lut.LAST_TIMES[lut._key(b, r, n, precision)]
        assert set(times) == set(lut.METHODS) and all(0 < t < 1e3 for t in times.values())
    lut.reset_lookup_stats()
    assert lut.ensure_methods(modes, r, b, precision=precision, device=dev) == got
    assert lut.LOOKUP_STATS == {"exact": 3, "nearest": 0, "heuristic": 0}


def test_autotune_on_a_miss_then_auto_hits_the_entries(dev, monkeypatch):
    """cp_cals under AUTO on the card autotunes each bucket's missing
    entries once, before any bucket runs; a second run hits them exactly,
    tunes nothing, and its MTTKRP results by route are the picks."""
    monkeypatch.delenv("CP_CALS_NO_AUTOTUNE")
    x, queue = _bench_problem(5, 1)
    params = CalsParams(max_iterations=4, force_max_iter=True, bucket_ranks=(4, 8, 12, 16, 20), buffer_size=200,
                        precision="high", mttkrp_precision="default")
    lut.reset_lookup_stats()
    cp_cals(x, queue, params)
    assert lut.LOOKUP_STATS["heuristic"] == 0
    demands = {}
    for kt in queue:
        demands[bucket_rank(kt.rank, params.bucket_ranks)] = demands.get(bucket_rank(kt.rank, params.bucket_ranks),
                                                                          0) + 1
    (wave,) = allocate_bucket_batches(demands, params.buffer_size)
    assert all(lut.has_exact_entries(x.shape, r, b, "default", dev) for r, b in wave.items())

    def refuse(*a, **k):
        raise AssertionError("autotune on an exact hit")

    monkeypatch.setattr(lut, "autotune", refuse)
    lut.reset_lookup_stats()
    _zero()
    _, rep = cp_cals(x, queue, params)
    assert lut.LOOKUP_STATS == {"exact": 3 * len(wave), "nearest": 0, "heuristic": 0}
    picks = {r: lut.lookup_methods(x.shape, r, b, "default", device=dev) for r, b in wave.items()}
    want = dict.fromkeys(launches.routes(), 0)
    for r, methods in picks.items():
        for m in methods:
            want["fused" if m == "pallas" else m] += rep.engine_iterations[r]
    assert launches.routes() == want
    assert fm.fused_mttkrp_tc.launches == want["fused"]


def test_compare_als_cals_on_the_card(dev, tmp_path):
    """The experiment harness's ALS-vs-CALS comparison (the quick base grid,
    50^3) on the card: the target drawn there, CALS through the kernels
    (the fp32 MTTKRP at "highest"), no model apart from its batched ALS."""
    from cp_cals_tpu_torch import experiments

    x, queue = experiments.make_workload((50, 50, 50), 1, 3, 2)
    assert x.is_cuda and x.dtype == torch.float32
    _zero()
    res = experiments.compare_als_cals(
        x, queue, CalsParams(max_iterations=5, force_max_iter=True, bucket_ranks=(4, 8, 12, 16, 20)),
        AlsParams(max_iterations=5, force_max_iter=True), out_dir=str(tmp_path), tag="50x50x50")
    assert res["n_models"] == 6 and res["n_mismatched"] == 0
    assert fm.fused_mttkrp_fp32.launches > 0 and fe.epilogue_apply.launches > 0
    assert (tmp_path / "cals_50x50x50.csv").exists()


def test_external_study_fused_rows_match_plain_on_the_card(dev):
    """The external MTTKRP study's float32 rows
    (studies/bench_mttkrp_external.py) at one small shape: both fused
    kernels at B = 1 on every mode, each launched for the warm-up and the
    timed rep only, each result within 2e-5 of max|G| of its plain version
    (the row raises beyond it) and near the float64 oracle; the float64
    contenders within the script's 1e-10."""
    from cp_cals_tpu_torch.studies import bench_mttkrp_external as ext

    launches.reset()
    rows = ext.run("40-30-20", "5", reps=1, device=dev)
    assert len(rows) == 3
    for row in rows:
        assert max(row["vs_oracle"].values()) <= ext.TOL
        for tier in ext.FUSED_TIERS:
            assert row[f"ours_fused_{tier}_gate"] == "taken"
            assert row[f"ours_fused_{tier}_launches"] == 2
            assert row[f"ours_fused_{tier}_vs_plain"] <= ext.FUSED_TOL
            assert row[f"ours_fused_{tier}_s"] > 0
        assert row["ours_fused_highest_vs_f64"] < 1e-5
        assert row["ours_fused_default_vs_f64"] < 5e-2
    assert fm.fused_mttkrp_fp32.launches == 6 and fm.fused_mttkrp_tc.launches == 6


def test_recorder_spans_and_clock_on_the_card(dev):
    """The program's recorder on the card: a CUDA-activity profiler (the
    benchmark's) switches it on; a spin kernel launched and waited for
    inside a span, 5 ms of host sleep on either side, lies inside the span
    on the profiler's clock with 2 ms to spare at each end; a jackknife's
    graphs are captured inside loop.capture spans, one per capture
    counted, and its reports equal the spans' totals."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from cp_cals_tpu_torch.utils import timers

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert timers.is_recording()
        with timers.span("check"):
            time.sleep(0.005)
            torch.cuda._sleep(20_000_000)  # a spin kernel of about 10 ms
            torch.cuda.synchronize(dev)
            time.sleep(0.005)
    assert not timers.is_recording()
    sp, = [s for s in timers.spans() if s.name == "check"]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA and "spin" in e.name()]
    assert len(ev) == 1, [e.name() for e in prof.profiler.kineto_results.events()]
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    lead, lag = start - sp.start_ns, sp.end_ns - end
    assert lead > 2_000_000 and lag > 2_000_000, (lead, lag)
    x, rng, modes = _als_problem(7, rank=3)
    kt = random_ktensor_host(rng, modes, 3)
    params = CalsParams(tol=1e-6, max_iterations=40, buffer_size=40, bucket_ranks=(4,), tol_check_interval=5,
                        polish_iters=25, polish_tol=1e-6, evict_batch=2, precision="high", mttkrp_precision="default")
    release_graphs()  # the call captures its own graphs
    with timers.recording():
        rep = jk_cp_cals(x, [kt], params)
    spans, counts = timers.spans(), timers.counters()
    (r, pt), = rep.cals_report.phase_times.items()
    lc = rep.cals_report.loop_counts[r]
    caps = [s for s in spans if s.name == "loop.capture"]
    assert len(caps) == lc["captures"] == counts["captures"] >= 2, (len(caps), lc, counts)
    assert lc["replays"] == counts["replays"] > 0, (lc, counts)
    assert pt["capture"] == sum(s.end_ns - s.start_ns for s in caps) / 1e9
    assert pt["evict"] == sum(s.end_ns - s.start_ns for s in spans if s.name == "evict.round") / 1e9
    assert lc["stats_fetches"] == sum(counts.get(f"fetches.{k}", 0) for k in ("chunk", "polish", "evict")), (lc, counts)
