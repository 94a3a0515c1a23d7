"""Fused per-mode ALS epilogue: two hand-written CUDA kernels and their
plain versions.

Replace ``cp_cals_tpu/ops/pallas_epilogue.py:_hinv_kernel`` and
``:_apply_kernel``. After mode n's MTTKRP G:

    H^-1          = inverse(padded_hadamard(prod_{k != n} grams[k], mask))
    U             = G H^-1, jackknife row zero (mode 0)
    gm_raw        = U^T U
    lam           = L2 (iteration 1, from diag(gm_raw)) or signed max after
    F             = U / safe(lam)
    t3 (last mode) = sum_i F[i, j] G[i, j] as double-float (hi, lo)

The kernels (``csrc/fused_epilogue.cu``) say what bounds them and what
their design does about that. The returned gramian is the raw U^T U; the
caller rescales it by safe(lam) outer safe(lam). Dead slots (rank mask all
False, zero factors) stay inert: identity H^-1, lam = 0, F = 0.

Each wrapper runs the plain version for tensors on the CPU and its kernel
for tensors on the card; any other case raises. The kernels take float32,
R up to ``MAX_R`` and 3-D tensors (two other-mode gramians per normal
matrix); ``apply`` also needs H^-1 and U to fit one block's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ktensor import scale_jk_rows
from .error import _df_add, _two_prod
from .gramians import gramian, hadamard_but_one
from .update import gj_inverse, padded_hadamard

MAX_R = 64  # csrc/fused_epilogue.cu: MAX_R


# ------------------------------------------------------------ plain versions


def normal_inverse_plain(grams, rank_mask: torch.Tensor, skip: int) -> torch.Tensor:
    return gj_inverse(padded_hadamard(hadamard_but_one(grams, skip), rank_mask))


def _df_fold_rows(hi: torch.Tensor, lo: torch.Tensor):
    """Pairwise double-float fold over axis -2 ([..., I, R] -> [..., R])."""
    while hi.shape[-2] > 1:
        n = hi.shape[-2]
        if n % 2:  # fold the odd last row into row 0 first
            h0, l0 = _df_add(
                (hi[..., :1, :], lo[..., :1, :]), (hi[..., n - 1 :, :], lo[..., n - 1 :, :])
            )
            hi = torch.cat([h0, hi[..., 1 : n - 1, :]], dim=-2)
            lo = torch.cat([l0, lo[..., 1 : n - 1, :]], dim=-2)
            n -= 1
        h = n // 2
        hi, lo = _df_add((hi[..., :h, :], lo[..., :h, :]), (hi[..., h:n, :], lo[..., h:n, :]))
    return hi[..., 0, :], lo[..., 0, :]


def epilogue_apply_plain(g, hinv, iters, jk_fiber, zero_jk: bool, with_err: bool):
    u = torch.matmul(g, hinv)
    if zero_jk:
        u = scale_jk_rows(u, jk_fiber, 0.0)
    gm = gramian(u)
    l2 = torch.sqrt(torch.abs(torch.diagonal(gm, dim1=-2, dim2=-1)))
    mx = torch.amax(u, dim=-2)
    mn = torch.amin(u, dim=-2)
    maxval = torch.where(mx >= -mn, mx, mn)
    lam = torch.where((iters == 1)[..., None], l2, maxval)
    safe = torch.where(lam != 0, lam, torch.ones_like(lam))
    f = u / safe[..., None, :]
    t3 = None
    if with_err:
        if f.dtype == torch.float64:
            hi = torch.sum(f * g, dim=-2)
            t3 = (hi, torch.zeros_like(hi))
        else:
            t3 = _df_fold_rows(*_two_prod(f, g))
    return f, lam, gm, t3


# ------------------------------------------------------------------ kernels


def _lib():
    lib = _build.load("fused_epilogue.cu")
    if lib.hinv_launch.argtypes is None:
        lib.hinv_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.hinv_launch.restype = ctypes.c_int
        lib.apply_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.apply_launch.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, device, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_rank(name: str, r: int) -> None:
    if r > MAX_R:
        raise ValueError(f"{name}: rank {r} above the kernel's maximum {MAX_R}")


def normal_inverse(grams, rank_mask: torch.Tensor, skip: int) -> torch.Tensor:
    """H^-1 of padded_hadamard(hadamard_but_one(grams, skip), rank_mask).

    grams: per-mode [B, R, R]; rank_mask [B, R] bool. Returns [B, R, R].
    """
    dev = rank_mask.device
    if dev.type == "cpu":
        return normal_inverse_plain(grams, rank_mask, skip)
    if dev.type != "cuda":
        raise ValueError(f"normal_inverse: unsupported device {dev}")
    others = [g for n, g in enumerate(grams) if n != skip]
    if len(others) != 2:
        raise ValueError(
            f"normal_inverse: {len(others)} other-mode gramians; the kernel takes the "
            "two of a 3-D tensor (N-D: ROADMAP queue 1 item 2)"
        )
    b, r, _ = others[0].shape
    _check_rank("normal_inverse", r)
    for g in others:
        if g.dtype != torch.float32 or tuple(g.shape) != (b, r, r):
            raise ValueError(f"normal_inverse: gramian {g.dtype} {tuple(g.shape)}")
    if rank_mask.dtype != torch.bool or tuple(rank_mask.shape) != (b, r):
        raise ValueError(f"normal_inverse: rank_mask {rank_mask.dtype} {tuple(rank_mask.shape)}")
    _check_cuda("normal_inverse", dev, rank_mask=rank_mask,
                **{f"gram{k}": g for k, g in enumerate(others)})
    out = torch.empty((b, r, r), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    code = _lib().hinv_launch(
        others[0].data_ptr(), others[1].data_ptr(), rank_mask.data_ptr(),
        out.data_ptr(), b, r, _build.stream_ptr(dev),
    )
    _build.check(code, "normal_inverse")
    normal_inverse.launches += 1
    return out


normal_inverse.launches = 0


def apply_smem_bytes(i_n: int, r: int) -> int:
    return (r * r + i_n * r + 4 * r) * 4


def epilogue_apply(
    g: torch.Tensor, hinv: torch.Tensor, iters: torch.Tensor,
    jk_fiber: torch.Tensor, zero_jk: bool, with_err: bool,
):
    """Fused U = G H^-1 -> JK zero -> normalize -> raw gramian (+ error
    columns). g [B, I, R], hinv [B, R, R], iters/jk_fiber [B] int32.
    Returns (f [B, I, R], lam [B, R], gm_raw [B, R, R], t3) with t3 =
    (hi [B, R], lo [B, R]) when with_err else None."""
    dev = g.device
    if dev.type == "cpu":
        return epilogue_apply_plain(g, hinv, iters, jk_fiber, zero_jk, with_err)
    if dev.type != "cuda":
        raise ValueError(f"epilogue_apply: unsupported device {dev}")
    b, i_n, r = g.shape
    _check_rank("epilogue_apply", r)
    smem_max = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if apply_smem_bytes(i_n, r) > smem_max:
        raise ValueError(
            f"epilogue_apply: I={i_n}, R={r} needs {apply_smem_bytes(i_n, r)} "
            f"bytes of shared memory, above the card's {smem_max} per block"
        )
    if g.dtype != torch.float32 or hinv.dtype != torch.float32:
        raise ValueError(f"epilogue_apply: float32 only, got {g.dtype}, {hinv.dtype}")
    if tuple(hinv.shape) != (b, r, r):
        raise ValueError(f"epilogue_apply: hinv shape {tuple(hinv.shape)}")
    for name, t in (("iters", iters), ("jk_fiber", jk_fiber)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"epilogue_apply: {name} must be int32 [{b}]")
    _check_cuda("epilogue_apply", dev, g=g, hinv=hinv, iters=iters, jk_fiber=jk_fiber)
    f = torch.empty_like(g)
    lam = torch.empty((b, r), dtype=torch.float32, device=dev)
    gm = torch.empty((b, r, r), dtype=torch.float32, device=dev)
    t3 = (torch.empty_like(lam), torch.empty_like(lam)) if with_err else None
    if b == 0:
        return f, lam, gm, t3
    code = _lib().apply_launch(
        g.data_ptr(), hinv.data_ptr(), iters.data_ptr(), jk_fiber.data_ptr(),
        f.data_ptr(), lam.data_ptr(), gm.data_ptr(),
        t3[0].data_ptr() if t3 else None, t3[1].data_ptr() if t3 else None,
        b, i_n, r, int(zero_jk), int(with_err), _build.stream_ptr(dev),
    )
    _build.check(code, "epilogue_apply")
    epilogue_apply.launches += 1
    return f, lam, gm, t3


epilogue_apply.launches = 0
