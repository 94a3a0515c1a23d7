"""Batched SPD inverse: the hand-written CUDA kernel and its plain version.

Replaces ``cp_cals_tpu/ops/pallas_solve.py:_gj_kernel`` (called through
``spd_inverse_pallas``). ``update_factor_unconstrained(solve="pallas")``
inverts every ``[B, R, R]`` normal matrix of the unfused epilogue with it.

The elimination is the TPU kernel's: unpivoted Gauss-Jordan with one
reciprocal of the pivot per step, then multiplies (``gj_inverse`` divides
instead). The kernel (``csrc/spd_inverse.cu``) is the Gauss-Jordan
elimination it shares with the normal inverse (``csrc/gj_elim.cuh``, which
says what bounds it and what its design does about that) behind a plain
load. ``gj_plan`` mirrors the launch plan of both.

``spd_inverse`` runs the plain version for a tensor on the CPU and the
kernel for one on the card; any other case raises. The kernel takes
float32, ``R <= MAX_R`` and a contiguous ``[B, R, R]`` batch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

MAX_R = 64  # csrc/gj_elim.cuh: GJ_MAX_R
# csrc/gj_elim.cuh: the warp path's largest R, models (warps) per block on
# it, and the block path's threads: BLOCK_COLS columns x ROW_GROUPS groups,
# thread (c, g) holding rows g, g + ROW_GROUPS, ... of column c.
WARP_MAX_R = 32
MODELS_PER_BLOCK = 4
BLOCK_COLS, ROW_GROUPS = 64, 8


class GjPlan(NamedTuple):
    path: str  # "warp" or "block"
    blocks: int
    threads: int


def gj_plan(b: int, r: int) -> GjPlan:
    """The launch plan of both inverse kernels at B models of rank R
    (``csrc/gj_elim.cuh:gj_plan``): for R <= WARP_MAX_R one warp per model,
    model = block * MODELS_PER_BLOCK + warp, lane c on column c; above, one
    block per model."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"gj_plan: rank {r} outside 1..{MAX_R}")
    if r <= WARP_MAX_R:
        return GjPlan("warp", -(-b // MODELS_PER_BLOCK), 32 * MODELS_PER_BLOCK)
    return GjPlan("block", b, BLOCK_COLS * ROW_GROUPS)


def spd_inverse_plain(h: torch.Tensor) -> torch.Tensor:
    """H^-1 of a batched SPD matrix ``[..., R, R]``, the TPU kernel's
    arithmetic step for step."""
    r = h.shape[-1]
    a = h
    inv = torch.eye(r, dtype=h.dtype, device=h.device).expand(h.shape)
    rows = torch.arange(r, device=h.device)[:, None]
    for j in range(r):
        rd = 1.0 / a[..., j : j + 1, j : j + 1]
        arow = a[..., j : j + 1, :] * rd
        irow = inv[..., j : j + 1, :] * rd
        colj = a[..., :, j : j + 1]
        is_j = rows == j
        a = torch.where(is_j, arow, a - colj * arow)
        inv = torch.where(is_j, irow, inv - colj * irow)
    return inv


def _lib():
    lib = _build.load("spd_inverse.cu")
    if lib.spd_inverse_launch.argtypes is None:
        lib.spd_inverse_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.spd_inverse_launch.restype = ctypes.c_int
        lib.gj_plan_of.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
        lib.gj_plan_of.restype = ctypes.c_int
    return lib


def built_plan(b: int, r: int) -> GjPlan:
    """The launch plan as the built library has it (needs the card's
    build); ``gj_plan`` must equal it."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    path = _lib().gj_plan_of(b, r, ctypes.byref(blocks), ctypes.byref(threads))
    return GjPlan(("warp", "block")[path], blocks.value, threads.value)


def spd_inverse(h: torch.Tensor) -> torch.Tensor:
    """H^-1 of a batched SPD matrix. h: [B, R, R] -> [B, R, R]."""
    dev = h.device
    if dev.type == "cpu":
        return spd_inverse_plain(h)
    if dev.type != "cuda":
        raise ValueError(f"spd_inverse: unsupported device {dev}")
    if h.ndim != 3 or h.shape[1] != h.shape[2]:
        raise ValueError(f"spd_inverse: expected [B, R, R], got {tuple(h.shape)}")
    b, r, _ = h.shape
    if h.dtype != torch.float32:
        raise ValueError(f"spd_inverse: float32 only, got {h.dtype}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"spd_inverse: rank {r} outside the kernel's 1..{MAX_R}")
    if not h.is_contiguous():
        raise ValueError("spd_inverse: h must be contiguous")
    out = torch.empty_like(h)
    if b == 0:
        return out
    code = _lib().spd_inverse_launch(h.data_ptr(), out.data_ptr(), b, r, _build.stream_ptr(dev))
    _build.check(code, "spd_inverse")
    spd_inverse.launches += 1
    return out


spd_inverse.launches = 0
