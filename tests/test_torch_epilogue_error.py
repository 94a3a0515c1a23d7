"""The apply with the gramian rescale and the FastALS error, and the fp32
MTTKRP's planner.

The port's apply (``cp_cals_tpu_torch/ops/fused_epilogue.py``) computes,
besides what the JAX apply kernel computes, the rescaled gramian and, on the
last mode, the error per model: what the JAX iteration runs right after the
kernel (the rescale, then ``cp_cals_tpu/ops/error.py:fast_error_from_cols``).
On the CPU its wrapper runs the plain version; it is held here against that
JAX composition, with the Pallas apply in interpret mode, on inputs made
with numpy from a seed (padded ranks, a dead slot, jackknife fibers): at
2e-4 in float32 (the JAX suite's epilogue band) and 1e-11 in float64.

The fp32 MTTKRP kernel's planner must cover every (j, k) of a mode exactly
once across its blocks, at the engine's shapes and for long modes whose U2
slice is split in k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu.ops.error import fast_error_from_cols as jax_fast_error_from_cols
from cp_cals_tpu.ops.pallas_epilogue import epilogue_apply_pallas
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops.gramians import gramians
from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches

H100_SMS, H100_SMEM = 132, 232448  # SMs and opt-in shared memory per block of an H100


def _problem(dtype, b=7, modes=(11, 9, 13), r=5, pad=3, seed=0):
    """Normalized factors with padded ranks and slot b-1 dead (rank mask all
    False, zero data); G of the last mode; jackknife fibers on some slots."""
    rng = np.random.default_rng(seed)
    rr = r + pad
    mask = np.broadcast_to(np.arange(rr) < r, (b, rr)).copy()
    mask[-1] = False
    mask[1, r - 1] = False  # one model of lower rank
    factors = []
    for m in modes:
        f = rng.normal(size=(b, m, rr)) * mask[:, None, :]
        f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-30)
        factors.append(f.astype(dtype))
    g = (rng.normal(size=(b, modes[2], rr)) * mask[:, None, :]).astype(dtype)
    jk = np.asarray([2, -1, 0, -1, 12, -1, 5], np.int32)[:b]
    x_norm = rng.uniform(8.0, 12.0, size=b).astype(dtype)
    return factors, mask, g, jk, x_norm


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4), (np.float64, 1e-11)])
@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("zero_jk", [False, True])
@pytest.mark.parametrize("iters_val", [1, 4])
def test_apply_matches_jax_apply_rescale_and_error(iters_val, zero_jk, with_err, dtype, tol):
    factors, mask, g, jk, x_norm = _problem(dtype, seed=iters_val + 2 * zero_jk)
    b = g.shape[0]
    grams = gramians([torch.from_numpy(f) for f in factors])
    hinv = fe.normal_inverse(grams, torch.from_numpy(mask), 2)
    iters = np.full((b,), iters_val, np.int32)
    err_inputs = (torch.from_numpy(x_norm), grams[0], grams[1]) if with_err else None
    f, lam, gm, err = fe.epilogue_apply(
        torch.from_numpy(g), hinv, torch.from_numpy(iters), torch.from_numpy(jk), zero_jk, err_inputs,
    )

    wf, wlam, wgm_raw, wt3 = epilogue_apply_pallas(
        jnp.asarray(g), jnp.asarray(hinv.numpy()), jnp.asarray(iters), jnp.asarray(jk),
        zero_jk=zero_jk, with_err=with_err, interpret=True,
    )
    safe = jnp.where(wlam != 0, wlam, 1.0)
    wgm = wgm_raw / (safe[..., :, None] * safe[..., None, :])
    for got, want in ((f, wf), (lam, wlam), (gm, wgm)):
        assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    assert not f[-1].any() and not lam[-1].any() and not gm[-1].any()  # the dead slot stays inert
    if zero_jk:
        for slot, fiber in enumerate(jk):
            if fiber >= 0:
                assert not f[slot, fiber].any()
    if with_err:
        h = jnp.asarray(grams[0].numpy()) * jnp.asarray(grams[1].numpy()) * wgm
        want = jax_fast_error_from_cols(jnp.asarray(x_norm), wlam, wt3[0], wt3[1], h)
        assert err.shape == (b,)
        np.testing.assert_allclose(err.numpy(), np.asarray(want), rtol=tol, atol=tol)
        # the dead slot's error is its model norm: nothing of it is fitted
        np.testing.assert_allclose(err[-1].item(), x_norm[-1], rtol=tol)
    else:
        assert err is None


def _engine_cases():
    """(B, R, J, I, K) of every bucket and mode of the bench workload
    (299x301x41, buckets 4/8/12/16/20, buffer_size=2880)."""
    modes = (299, 301, 41)
    (alloc,) = allocate_bucket_batches({r: 80 for r in (4, 8, 12, 16, 20)}, 2880)
    cases = []
    for r, b in sorted(alloc.items()):
        for mode in range(3):
            small, big = fm.split_others(modes, mode)
            cases.append((b, r, modes[small], modes[mode], modes[big]))
    return cases


def _covers_once(j, i, k, c, plan):
    tile, kspan, ksplits, jsplits, jchunk = plan
    assert kspan % 16 == 0 and fm.fp32_smem(tile, kspan) <= H100_SMEM
    seen = np.zeros((j, k), np.int8)
    for z in range(ksplits * jsplits):  # blockIdx.z = ks * jsplits + js, as in the kernel
        ks, js = divmod(z, jsplits)
        k0, j0 = ks * kspan, js * jchunk
        assert k0 < k and j0 < j  # no empty range
        seen[j0 : min(j, j0 + jchunk), k0 : min(k, k0 + kspan)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,r,j,i,k", _engine_cases())
def test_fp32_plan_covers_each_j_and_k_once_at_the_engine_shapes(b, r, j, i, k):
    """One k range (U2 whole in shared memory), one wave of blocks, and the
    row tile with the fewest padded rows: 48 for the 41-row mode, 64 for
    the modes of 299 and 301."""
    plan = fm.plan_fp32(j, i, k, b * r, H100_SMS, H100_SMEM)
    _covers_once(j, i, k, b * r, plan)
    tile, _, ksplits, jsplits, _ = plan
    tm = fm.FP32_TILES[tile][0]
    assert ksplits == 1 and tm == (48 if i == 41 else 64)
    assert -(-b * r // 128) * -(-i // tm) * jsplits <= H100_SMS


@pytest.mark.parametrize("j,i,k,c", [
    (3, 70, 3001, 30),     # K = 3,001: U2 split into k ranges
    (2, 40, 6007, 24),     # K = 6,007
    (17, 17, 17, 64),      # one partial 16-k stage
    (1, 20, 30, 3),        # J = 1
    (299, 41, 20000, 768),  # many k ranges: no j split is needed to fill the card
])
def test_fp32_plan_covers_each_j_and_k_once_for_long_and_short_modes(j, i, k, c):
    plan = fm.plan_fp32(j, i, k, c, H100_SMS, H100_SMEM)
    _covers_once(j, i, k, c, plan)
    if k > 416:  # more than one range's U2 slice fits
        assert plan[2] > 1


def _block_stages(nj, nk, ng):
    """The fp32 kernel's schedule of one block (csrc/fused_mttkrp.cu:
    mttkrp_kernel): per stage, each group's (j, k stage), or None
    where the group computes nothing."""
    rem = nj % ng
    parts = ng // rem if rem and ng % rem == 0 else 1
    rounds = nj // ng if parts > 1 else -(-nj // ng)
    h = -(-nk // parts)
    stages = []
    for t in range(rounds * nk + (h if parts > 1 else 0)):
        jobs = []
        for g in range(ng):
            if t < rounds * nk:
                j, kc = (t // nk) * ng + g, t % nk
            else:
                j, kc = rounds * ng + g // parts, (g % parts) * h + t - rounds * nk
            jobs.append((j, kc) if j < nj and kc < nk else None)
        stages.append(jobs)
    return stages


@pytest.mark.parametrize("ng", [2, 4])
@pytest.mark.parametrize("nk", [1, 2, 19])
def test_fp32_block_covers_each_j_and_stage_once(ng, nk):
    """Within a block, every (j, k stage) is computed exactly once, and the
    stage count is ``fp32_rounds`` rounds of nk stages (the split round's
    parts rounded up to whole stages)."""
    for nj in range(1, 10):
        stages = _block_stages(nj, nk, ng)
        seen = np.zeros((nj, nk), np.int8)
        for jobs in stages:
            for job in jobs:
                if job is not None:
                    seen[job] += 1
        assert (seen == 1).all()
        rounds = fm.fp32_rounds(nj, ng)
        split = rounds % 1  # the split round's share of a round: 1 / parts
        assert len(stages) == int(rounds) * nk + (-(-nk // round(1 / split)) if split else 0)
