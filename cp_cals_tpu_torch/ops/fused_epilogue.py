"""Fused per-mode ALS epilogue: two hand-written CUDA kernels and their
plain versions.

Replace ``cp_cals_tpu/ops/pallas_epilogue.py:_hinv_kernel`` and
``:_apply_kernel``, the latter with the two steps the JAX iteration runs
right after it (the gramian rescale and ``ops/error.py:
fast_error_from_cols``). After mode n's MTTKRP G:

    H^-1          = inverse(padded_hadamard(prod_{k != n} grams[k], mask))
    U             = G H^-1, jackknife row zero (mode 0)
    lam           = L2 (iteration 1, from diag(U^T U)) or signed max after
    F             = U / safe(lam)
    gm            = U^T U / (safe(lam) outer safe(lam)), the new gramian
    err (last mode) = the FastALS error from x_norm, lam, the double-float
                    column sums sum_i F[i, j] G[i, j] and the hadamard of
                    the other modes' gramians and gm

The kernels (``csrc/fused_epilogue.cu``) say what bounds them and what
their design does about that. Dead slots (rank mask all False, zero
factors) stay inert: identity H^-1, lam = 0, F = 0.

Each wrapper runs the plain version for tensors on the CPU and its kernel
for tensors on the card; any other case raises. The kernels take float32,
R up to ``MAX_R`` and 3-D tensors (two other-mode gramians per normal
matrix); ``apply`` also needs H^-1 and G (then U) to fit one block's shared
memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..ktensor import scale_jk_rows
from .error import _df_add, _two_prod, fast_error_from_cols
from .gramians import gramian, hadamard_all, hadamard_but_one
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


def _apply_raw_plain(g, hinv, iters, jk_fiber, zero_jk: bool, with_err: bool):
    """The JAX apply kernel's function: (F, lam, raw U^T U, error columns
    (hi, lo) or None)."""
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


def epilogue_apply_plain(g, hinv, iters, jk_fiber, zero_jk: bool, err_inputs=None):
    """The apply, the gramian rescale, and on the error mode
    ``fast_error_from_cols``: the composition the iteration ran before the
    kernel took over the last two."""
    f, lam, gm_raw, t3 = _apply_raw_plain(g, hinv, iters, jk_fiber, zero_jk, err_inputs is not None)
    safe = torch.where(lam != 0, lam, torch.ones_like(lam))
    gm = gm_raw / (safe[..., :, None] * safe[..., None, :])
    err = None
    if err_inputs is not None:
        x_norm, gram_a, gram_b = err_inputs
        err = fast_error_from_cols(x_norm, lam, t3[0], t3[1], hadamard_all((gram_a, gram_b, gm)))
    return f, lam, gm, err


# ------------------------------------------------------------------ kernels


def _lib():
    lib = _build.load("fused_epilogue.cu")
    if lib.hinv_launch.argtypes is None:
        lib.hinv_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.hinv_launch.restype = ctypes.c_int
        lib.apply_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.apply_launch.restype = ctypes.c_int
        lib.apply_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.apply_smem_bytes.restype = ctypes.c_longlong
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
    The engine calls it once per mode, so its checks build no strings or
    tuples unless they fail.
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
    g0, g1 = others
    b, r, r2 = shape = g0.shape
    _check_rank("normal_inverse", r)
    for g in others:
        if g.dtype != torch.float32 or g.shape != shape or r2 != r:
            raise ValueError(f"normal_inverse: gramian {g.dtype} {tuple(g.shape)}")
        if g.device != dev:
            raise ValueError(f"normal_inverse: a gramian is on {g.device}, expected {dev}")
        if not g.is_contiguous():
            raise ValueError("normal_inverse: the gramians must be contiguous")
    if rank_mask.dtype != torch.bool or rank_mask.shape != (b, r):
        raise ValueError(f"normal_inverse: rank_mask {rank_mask.dtype} {tuple(rank_mask.shape)}")
    if not rank_mask.is_contiguous():
        raise ValueError("normal_inverse: rank_mask must be contiguous")
    out = torch.empty_like(g0)  # a little cheaper than torch.empty with its keywords
    if b == 0:
        return out
    code = _lib().hinv_launch(
        g0.data_ptr(), g1.data_ptr(), rank_mask.data_ptr(), out.data_ptr(), b, r,
        _build.stream_ptr(dev),
    )
    _build.check(code, "normal_inverse")
    normal_inverse.launches += 1
    return out


normal_inverse.launches = 0


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def epilogue_apply(
    g: torch.Tensor, hinv: torch.Tensor, iters: torch.Tensor,
    jk_fiber: torch.Tensor, zero_jk: bool, err_inputs=None,
):
    """Fused U = G H^-1 -> JK zero -> normalize -> rescaled gramian, and on
    the error mode the FastALS error. g [B, I, R], hinv [B, R, R],
    iters/jk_fiber [B] int32; err_inputs None, or on the error mode
    (x_norm [B], gram_a [B, R, R], gram_b [B, R, R]): the model norms and
    the other two modes' rescaled gramians in mode order. Returns (f
    [B, I, R], lam [B, R], gm [B, R, R], err [B] or None)."""
    dev = g.device
    if dev.type == "cpu":
        return epilogue_apply_plain(g, hinv, iters, jk_fiber, zero_jk, err_inputs)
    if dev.type != "cuda":
        raise ValueError(f"epilogue_apply: unsupported device {dev}")
    b, i_n, r = g.shape
    _check_rank("epilogue_apply", r)
    smem_max = _smem_optin(dev.index if dev.index is not None else torch.cuda.current_device())
    smem = _lib().apply_smem_bytes(i_n, r)
    if smem > smem_max:
        raise ValueError(
            f"epilogue_apply: I={i_n}, R={r} needs {smem} bytes of shared memory (H^-1, "
            f"G and four R-vectors), above the card's {smem_max} per block"
        )
    if g.dtype != torch.float32 or hinv.dtype != torch.float32:
        raise ValueError(f"epilogue_apply: float32 only, got {g.dtype}, {hinv.dtype}")
    if tuple(hinv.shape) != (b, r, r):
        raise ValueError(f"epilogue_apply: hinv shape {tuple(hinv.shape)}")
    for name, t in (("iters", iters), ("jk_fiber", jk_fiber)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"epilogue_apply: {name} must be int32 [{b}]")
    tensors = dict(g=g, hinv=hinv, iters=iters, jk_fiber=jk_fiber)
    if err_inputs is not None:
        x_norm, gram_a, gram_b = err_inputs
        if x_norm.dtype != torch.float32 or tuple(x_norm.shape) != (b,):
            raise ValueError(f"epilogue_apply: x_norm must be float32 [{b}], got {x_norm.dtype} "
                             f"{tuple(x_norm.shape)}")
        for name, t in (("gram_a", gram_a), ("gram_b", gram_b)):
            if t.dtype != torch.float32 or tuple(t.shape) != (b, r, r):
                raise ValueError(f"epilogue_apply: {name} must be float32 [{b}, {r}, {r}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
        tensors.update(x_norm=x_norm, gram_a=gram_a, gram_b=gram_b)
    _check_cuda("epilogue_apply", dev, **tensors)
    f = torch.empty_like(g)
    lam = torch.empty((b, r), dtype=torch.float32, device=dev)
    gm = torch.empty((b, r, r), dtype=torch.float32, device=dev)
    err = torch.empty((b,), dtype=torch.float32, device=dev) if err_inputs is not None else None
    if b == 0:
        return f, lam, gm, err
    extra = [t.data_ptr() for t in err_inputs] if err_inputs is not None else [None] * 3
    code = _lib().apply_launch(
        g.data_ptr(), hinv.data_ptr(), iters.data_ptr(), jk_fiber.data_ptr(), *extra,
        f.data_ptr(), lam.data_ptr(), gm.data_ptr(), err.data_ptr() if err is not None else None,
        b, i_n, r, int(zero_jk), _build.stream_ptr(dev),
    )
    _build.check(code, "epilogue_apply")
    epilogue_apply.launches += 1
    return f, lam, gm, err


epilogue_apply.launches = 0
