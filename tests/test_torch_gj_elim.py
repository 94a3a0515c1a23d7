"""The schedule of the shared Gauss-Jordan kernels (``csrc/gj_elim.cuh``),
emulated in numpy float32 on the CPU.

The kernels cannot run here, so their schedule is replayed step for step:
the warp path keeps one column per lane with the rows rotated through the
slots (each step's pivot column read from lane j before any update), the
block path stages the pivot row and column before each step. The
emulations use separate products and differences, as the plain versions
do, so they must be bit-equal to ``normal_inverse_plain`` (pivot row
divided by the pivot) and ``spd_inverse_plain`` (one reciprocal, then
products); the kernels differ from them only by contracting each row
update into one FMA, which the card tests hold at 1e-6 * cond * max|H^-1|.
Also here: padding a matrix with identity rows and columns leaves the
inverse bit for bit, the launch plan's mirror covers every model and every
(row, column) exactly once, and the warp schedule agrees with the JAX
package's kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu.ops.pallas_epilogue import normal_inverse_pallas
from cp_cals_tpu.ops.pallas_solve import spd_inverse_pallas
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops import spd_inverse as si
from cp_cals_tpu_torch.ops.update import gj_inverse

ONE = np.float32(1)
WARP_RANKS = [1, 4, 5, 8, 12, 16, 20, 32]
BLOCK_RANKS = [33, 48, 64]


def _scale(reciprocal: bool, d, a_row, v_row):
    """The pivot arithmetic of each front end, per lane: division
    (``gj_inverse``) or one reciprocal and products (``spd_inverse_plain``)."""
    if reciprocal:
        rd = ONE / d
        return a_row * rd[:, None], v_row * rd[:, None]
    return a_row / d[:, None], v_row / d[:, None]


def warp_schedule(h: np.ndarray, reciprocal: bool) -> np.ndarray:
    """The warp path: ``a[:, s, c]`` is slot s of lane c's column. At step j
    slot 0 holds row j; lane j's slots are column j, which every lane holds
    before any update (the kernel shuffles each entry of it from lane j as
    the previous step produces it); row (j + s) mod R moves to slot s - 1
    and the scaled pivot row to the last slot."""
    b, r, _ = h.shape
    a = h.astype(np.float32).copy()
    v = np.broadcast_to(np.eye(r, dtype=np.float32), h.shape).copy()
    for j in range(r):
        colj = a[:, :, j].copy()  # __shfl_sync(a[s], j) for every slot s
        pa, pv = _scale(reciprocal, colj[:, 0], a[:, 0, :], v[:, 0, :])
        a_new, v_new = np.empty_like(a), np.empty_like(v)
        a_new[:, :-1, :] = a[:, 1:, :] - colj[:, 1:, None] * pa[:, None, :]
        v_new[:, :-1, :] = v[:, 1:, :] - colj[:, 1:, None] * pv[:, None, :]
        a_new[:, -1, :], v_new[:, -1, :] = pa, pv
        a, v = a_new, v_new
    return v  # R rotations: slot s holds row s again


def block_schedule(h: np.ndarray, reciprocal: bool) -> np.ndarray:
    """The block path: each element stays in place; the pivot row of A and
    V and the pivot column of A are staged (written by the previous step's
    updates of row and column j) before step j reads them."""
    b, r, _ = h.shape
    a = h.astype(np.float32).copy()
    v = np.broadcast_to(np.eye(r, dtype=np.float32), h.shape).copy()
    arow, vrow, acol = a[:, 0, :].copy(), v[:, 0, :].copy(), a[:, :, 0].copy()
    for j in range(r):
        pa, pv = _scale(reciprocal, arow[:, j], arow, vrow)
        a = a - acol[:, :, None] * pa[:, None, :]
        v = v - acol[:, :, None] * pv[:, None, :]
        a[:, j, :], v[:, j, :] = pa, pv
        if j + 1 < r:
            arow, vrow, acol = a[:, j + 1, :].copy(), v[:, j + 1, :].copy(), a[:, :, j + 1].copy()
    return v


def schedule(h, reciprocal):
    return (warp_schedule if h.shape[-1] <= si.WARP_MAX_R else block_schedule)(h, reciprocal)


def _grams(rng, b, r, n_modes=3):
    """Gramians of random factors (more rows than columns), float32."""
    out = []
    for _ in range(n_modes):
        f = rng.normal(size=(b, r + 6, r))
        out.append((np.transpose(f, (0, 2, 1)) @ f / (r + 6)).astype(np.float32))
    return out


def _mask(b, r):
    """Ranks spread over r-2..r, and the last slot dead."""
    true = np.array([max(1, r - s % 3) for s in range(b)])
    true[-1] = 0
    return np.arange(r)[None, :] < true[:, None]


def _front_end(g0, g1, mask):
    """The normal inverse's front end, padded_hadamard(g0 * g1, mask), in
    numpy float32 as the kernel's loader computes it."""
    m = mask.astype(np.float32)
    eye = np.eye(mask.shape[1], dtype=np.float32)
    return (g0 * g1) * (m[:, :, None] * m[:, None, :]) + eye * (ONE - m[:, None, :])


@pytest.mark.parametrize("r", WARP_RANKS + BLOCK_RANKS)
def test_normal_inverse_schedule_is_bit_equal_to_plain(r):
    rng = np.random.default_rng(100 + r)
    b, skip = 7, r % 3
    grams = _grams(rng, b, r)
    mask = _mask(b, r)
    others = [g for n, g in enumerate(grams) if n != skip]
    got = schedule(_front_end(*others, mask), reciprocal=False)
    want = fe.normal_inverse_plain([torch.from_numpy(g) for g in grams], torch.from_numpy(mask), skip)
    np.testing.assert_array_equal(got, want.numpy())
    # masked rows and columns, and the dead slot, are exactly the identity
    pad = ~mask[:, :, None] | ~mask[:, None, :]
    np.testing.assert_array_equal(got[pad], np.broadcast_to(np.eye(r, dtype=np.float32), got.shape)[pad])


@pytest.mark.parametrize("r", WARP_RANKS + BLOCK_RANKS)
def test_spd_inverse_schedule_is_bit_equal_to_plain(r):
    rng = np.random.default_rng(200 + r)
    h = _grams(rng, 9, r, n_modes=1)[0]
    h[4] = np.eye(r)  # a dead slot
    got = schedule(h, reciprocal=True)
    np.testing.assert_array_equal(got, si.spd_inverse_plain(torch.from_numpy(h)).numpy())
    np.testing.assert_array_equal(got[4], np.eye(r))


@pytest.mark.parametrize("reciprocal", [False, True])
@pytest.mark.parametrize("r,size", [(1, 4), (4, 8), (5, 8), (12, 16), (20, 32), (33, 64)])
def test_identity_padding_to_a_size_class_is_exact(r, size, reciprocal):
    """Each padded pivot is 1 and every padded entry of the real rows and
    columns 0, so the real block sees the same operations."""
    h = _grams(np.random.default_rng(r), 5, r, n_modes=1)[0]
    padded = np.broadcast_to(np.eye(size, dtype=np.float32), (5, size, size)).copy()
    padded[:, :r, :r] = h
    inverse = si.spd_inverse_plain if reciprocal else gj_inverse
    want = inverse(torch.from_numpy(h))
    got = inverse(torch.from_numpy(padded))
    assert torch.equal(got[:, :r, :r], want)
    assert torch.equal(got[:, r:, r:], torch.eye(size - r).expand(5, -1, -1))
    assert not got[:, :r, r:].any() and not got[:, r:, :r].any()


@pytest.mark.parametrize("path", ["warp", "block"])
def test_launch_plan_covers_every_model_and_element_once(path):
    ranks = range(1, si.WARP_MAX_R + 1) if path == "warp" else range(si.WARP_MAX_R + 1, si.MAX_R + 1)
    for r in ranks:
        for b in (1, 2, 3, 4, 5, 7, 32, 64, 96, 97, 320):
            plan = si.gj_plan(b, r)
            assert plan.path == path
            if path == "warp":
                assert plan.threads == 32 * si.MODELS_PER_BLOCK
                models = [blk * si.MODELS_PER_BLOCK + w for blk in range(plan.blocks)
                          for w in range(si.MODELS_PER_BLOCK)]
                assert sorted(m for m in models if m < b) == list(range(b))
                assert max(models) < b + si.MODELS_PER_BLOCK - 1  # no block without a model
                assert r <= 32  # lane c < R holds column c: one warp covers the columns
            else:
                assert plan.blocks == b and plan.threads == si.BLOCK_COLS * si.ROW_GROUPS
                owned = [(g + si.ROW_GROUPS * k, c) for c in range(si.BLOCK_COLS)
                         for g in range(si.ROW_GROUPS) for k in range(si.MAX_R // si.ROW_GROUPS)
                         if c < r and g + si.ROW_GROUPS * k < r]
                assert sorted(owned) == [(i, j) for i in range(r) for j in range(r)]
    for bad in (0, si.MAX_R + 1):
        with pytest.raises(ValueError):
            si.gj_plan(4, bad)


@pytest.mark.parametrize("r", [4, 8])
def test_warp_schedule_matches_the_jax_kernels(r):
    """The same schedule against the JAX package's Pallas kernels in
    interpret mode: the SPD inverse within 100 * cond * eps32 of max|H^-1|
    (tests/test_torch_solve.py's bound), the normal inverse at 2e-4
    (tests/test_torch_kernels.py's)."""
    rng = np.random.default_rng(r)
    h = _grams(rng, 6, r, n_modes=1)[0]
    want = np.asarray(spd_inverse_pallas(jnp.asarray(h), interpret=True))
    got = warp_schedule(h, reciprocal=True)
    cond = np.linalg.cond(h.astype(np.float64))
    scale = np.abs(want).max(axis=(1, 2))
    assert (np.abs(got - want).max(axis=(1, 2)) <= 100 * cond * np.finfo(np.float32).eps * scale).all()
    grams, mask = _grams(rng, 6, r), _mask(6, r)
    want = np.asarray(normal_inverse_pallas(tuple(jnp.asarray(g) for g in grams), jnp.asarray(mask), 1,
                                            interpret=True))
    got = warp_schedule(_front_end(grams[0], grams[2], mask), reciprocal=False)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
