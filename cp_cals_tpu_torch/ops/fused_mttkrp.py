"""Fused 3-D MTTKRP: the hand-written CUDA kernel and its plain version.

Replaces ``cp_cals_tpu/ops/pallas_mttkrp.py:_mttkrp_kernel``. For each
target mode the tensor is laid out once per solve as ``[J, I, K]``
(``prepare_mode_tensor``): J the small other mode, I the target mode, K the
big other mode. Then

    G[b, n, r] = sum_j U1[b, j, r] * sum_k X[j, n, k] * U2[b, k, r]

with U1 = factors[small], U2 = factors[big], all in the engine's
``[B, I_m, R]`` layout. The kernel (``csrc/fused_mttkrp.cu``) says what
bounds it and what its design does about that. The TPU kernel's lane
padding (``_pick_db``), its row-tile and j-chunk gates and its VMEM gate
are TPU artifacts and have no counterpart here.

``fused_mttkrp`` runs the plain version for a tensor on the CPU, and the
kernel for one on the card; any other case raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

TIERS = {"highest": 0, "high": 1, "default": 2}
_TM, _TN = 64, 128  # output tile of the kernel (rows, columns)


def split_others(shape, mode: int) -> tuple[int, int]:
    """(small, big) non-target modes; big is the contracted axis. Ties go to
    the lowest index, as in the TPU kernel (the twostep's go to the highest)."""
    others = [m for m in range(3) if m != mode]
    big = max(others, key=lambda m: shape[m])
    small = [m for m in others if m != big][0]
    return small, big


def prepare_mode_tensor(x: torch.Tensor, mode: int) -> torch.Tensor:
    """The kernel's ``[J, I, K]`` layout of mode ``mode`` (one copy of X)."""
    small, big = split_others(tuple(x.shape), mode)
    return x.permute(small, mode, big).contiguous()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def fused_mttkrp_plain(
    x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, precision: str
) -> torch.Tensor:
    """Plain PyTorch version: ``w_j = X_j @ U2`` per j, with the tier's
    bf16 rounding emulated in the working dtype, then ``sum_j w_j * U1[j]``."""
    j, i, k = x3.shape
    b, _, r = u1.shape
    u1p = u1.permute(1, 0, 2).reshape(j, b * r)
    u2p = u2.permute(1, 0, 2).reshape(k, b * r)
    if precision == "highest":
        w = torch.matmul(x3, u2p)
    elif precision == "default":
        w = torch.matmul(_bf16(x3), _bf16(u2p))
    elif precision == "high":
        xh, uh = _bf16(x3), _bf16(u2p)
        xl, ul = _bf16(x3 - xh), _bf16(u2p - uh)
        w = torch.matmul(xh, uh)
        w = w + torch.matmul(xh, ul)
        w = w + torch.matmul(xl, uh)
    else:
        raise ValueError(f"precision {precision!r}")
    g = (w * u1p[:, None, :]).sum(0)  # [I, B*R]
    return g.reshape(i, b, r).permute(1, 0, 2).contiguous()


def splits_for(j: int, i: int, c: int, n_sm: int) -> tuple[int, int]:
    """(splits, j per split) so the grid has about two blocks per SM."""
    tiles = -(-c // _TN) * -(-i // _TM)
    want = max(1, min(j, -(-2 * n_sm // tiles)))
    jchunk = -(-j // want)
    return -(-j // jchunk), jchunk


def _lib():
    lib = _build.load("fused_mttkrp.cu")
    fn = lib.fused_mttkrp_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_mttkrp(
    x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
    precision: str = "highest",
) -> torch.Tensor:
    """x3 [J, I, K], u1 [B, J, R], u2 [B, K, R] -> G [B, I, R]."""
    if x3.device.type == "cpu":
        return fused_mttkrp_plain(x3, u1, u2, precision)
    if x3.device.type != "cuda":
        raise ValueError(f"fused_mttkrp: unsupported device {x3.device}")
    if precision not in TIERS:
        raise ValueError(f"precision {precision!r}")
    j, i, k = x3.shape
    b, j1, r = u1.shape
    for name, t in (("x3", x3), ("u1", u1), ("u2", u2)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_mttkrp: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.device != x3.device:
            raise ValueError(f"fused_mttkrp: {name} must be contiguous on {x3.device}")
    if j1 != j or tuple(u2.shape) != (b, k, r):
        raise ValueError(
            f"fused_mttkrp: shapes x3 {tuple(x3.shape)}, u1 {tuple(u1.shape)}, "
            f"u2 {tuple(u2.shape)} do not agree"
        )
    out = torch.empty((b, i, r), dtype=torch.float32, device=x3.device)
    if out.numel() == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x3.device).multi_processor_count
    splits, jchunk = splits_for(j, i, b * r, n_sm)
    work = (
        torch.empty((splits, i, b * r), dtype=torch.float32, device=x3.device)
        if splits > 1 else None
    )
    code = _lib()(
        x3.data_ptr(), u1.data_ptr(), u2.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        j, i, k, b, r, TIERS[precision], splits, jchunk,
        _build.stream_ptr(x3.device),
    )
    _build.check(code, "fused_mttkrp")
    fused_mttkrp.launches += 1
    return out


fused_mttkrp.launches = 0


def mttkrp_batched_fused(
    x: torch.Tensor, factors, mode: int,
    prepared: torch.Tensor | None = None, precision: str = "highest",
) -> torch.Tensor:
    """Batched fused MTTKRP. factors: per-mode [B, I_m, R]; returns
    [B, I_mode, R]. ``prepared`` is ``prepare_mode_tensor(x, mode)``."""
    small, big = split_others(tuple(x.shape), mode)
    x3 = prepared if prepared is not None else prepare_mode_tensor(x, mode)
    return fused_mttkrp(x3, factors[small], factors[big], precision)
