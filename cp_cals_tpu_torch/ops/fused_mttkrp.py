"""Fused 3-D MTTKRP: the hand-written CUDA kernels and their plain version.

Replaces ``cp_cals_tpu/ops/pallas_mttkrp.py:_mttkrp_kernel``. For each
target mode the tensor is laid out once per solve (``prepare_mode_tensor``)
as ``[J, I, K]``: J the small other mode, I the target mode, K the big other
mode. Then

    G[b, n, r] = sum_j U1[b, j, r] * sum_k X[j, n, k] * U2[b, k, r]

with U1 = factors[small], U2 = factors[big], all in the engine's
``[B, I_m, R]`` layout.

The layout is held per precision tier, so X is rounded once per solve and
not at every load:

- ``"highest"``: X itself in the working dtype, as ``[J, K, I]`` (i
  contiguous): a view whose rows are padded with zeros to Ip, a multiple of
  4, so that every row starts 16-byte aligned for the kernel's TMA copies;
- ``"default"``: ``bf16(X)``, bfloat16 ``[J, I, Kp]``;
- ``"high"``: the bf16 hi/lo split of X, bfloat16 ``[2, J, I, Kp]`` (hi,
  then lo).

Kp is K padded with zeros to a multiple of 8, so that every row is 16-byte
aligned for the kernel's copies (the TPU prepare pads K to 8 as well). The
TPU kernel holds ``[J, I, K]`` at every tier; the port's "highest" layout
puts I last so that the fp32 kernel's copies land as its FFMA loop reads
them.

On the card ``"highest"`` (strict fp32) runs ``csrc/fused_mttkrp.cu`` on the
CUDA cores, and the bf16 tiers run ``csrc/fused_mttkrp_tc.cu`` on the tensor
cores; each source says what bounds it and what its design does about that.
The TPU kernel's lane padding (``_pick_db``), its row-tile and j-chunk gates
and its VMEM gate are TPU artifacts and have no counterpart here.

Each kernel's wrapper runs the plain version for a tensor on the CPU and its
kernel for one on the card; any other case raises.

Both kernels take an optional predicate: a device int32 tensor of one
element. Where it holds 0, every block returns at once and the output is
left unwritten, so a launch the iteration may not need (the mixed-tier
check's full-precision MTTKRP, ``solvers/iteration.py``) costs one empty
launch instead of a host sync to decide it. Such launches count on the
wrapper's ``predicated`` counter, apart from ``launches``. On the CPU the
plain version ignores the predicate and always computes.

Each kernel's plan (its tile, k ranges and j ranges; ``plan_fp32``,
``plan_tc``) is the planner's unless the caller passes one (``plan=``, the
counterpart of the Pallas kernel's ``db=``/``cj=``, which
``profiles/tune_pallas_mttkrp.py`` sweeps). A given plan is checked in
Python before the launch (``check_fp32_plan``, ``check_tc_plan``) and an
illegal one raises ``ValueError``; no plan falls back to another. On the
CPU the plain version ignores the plan, as it ignores the predicate.

Where the tensor-core kernel's output tiles leave some of the card's block
slots idle in its last wave, ``plan_tc`` may split j over more waves than
one (``tc_cost``); each such launch counts on ``BALANCED`` and, while the
recorder is on, as ``mttkrp.tc_balanced``, which a CUDA graph's replay adds
(``solvers/graph_loop.Graph``). The wrapper's own launch count holds every
tensor-core launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, launches
from ..launches import Tally
from ..utils import timers

TIERS = ("highest", "high", "default")
PLANES = {"default": 1, "high": 2}  # bf16 planes of the held X at the bf16 tiers
_TN = 128  # columns of an output tile of the fp32 kernel
# The fp32 kernel's tile shapes (csrc/fused_mttkrp.cu: FP32_TILES), by id:
# (rows, rows per thread, columns per thread, j groups per block). The
# planner on the card reads the built kernel's own table and shared-memory
# sizes; this copy and ``fp32_smem`` serve the planner without a card, and
# a ``cuda`` test holds them equal to the library's.
FP32_TILES = {0: (64, 8, 8, 2), 1: (48, 16, 4, 4)}
_FP32_TK, _FP32_STAGES = 16, 4  # k per ring stage and ring depth of the fp32 kernel
_TC_NC = (128, 64, 32, 16)  # column tiles of the tensor-core kernel, widest first
_TC_TM = 64  # rows of an output tile of the tensor-core kernel
_TC_KS = 64  # k per ring stage of the tensor-core kernel; its k ranges are whole stages
# What a block of the tensor-core kernel costs besides its ring stages (U2
# staged, the ring filled, its sum written), in ring stages: the
# least-squares fit (each launch shape its own time a stage) of 136 launches
# of 30 to 1,500 blocks in 27 shapes on an H100, at 500^3 "high" and at
# 299x301x41 at both bf16 tiers (PERF.md §6). Any value from 18 to 34
# gives the same plans there.
_TC_BLOCK_STAGES = 21
# More waves are taken below this share of one wave's cost (tc_cost): in
# the 109 plans of those shapes timed against their one-wave plan, the
# measured share came out at most 6.6 % above the modelled one, and
# 1 / 1.066 = 0.938.
_TC_MARGIN = 0.93
BALANCED = Tally(fixed=("tc_balanced",))  # tensor-core launches whose j splits fill more than one wave


def split_others(shape, mode: int) -> tuple[int, int]:
    """(small, big) non-target modes; big is the contracted axis. Ties go to
    the lowest index, as in the TPU kernel (the twostep's go to the highest)."""
    others = [m for m in range(3) if m != mode]
    big = max(others, key=lambda m: shape[m])
    small = [m for m in others if m != big][0]
    return small, big


def padded_k(k: int) -> int:
    """Kp: K rounded up to a multiple of 8."""
    return -(-k // 8) * 8


def padded_i(i: int) -> int:
    """Ip: the row stride of the "highest" layout, I rounded up to a multiple of 4."""
    return -(-i // 4) * 4


def held_nbytes(shape, mode: int, precision: str, itemsize: int) -> int:
    """The bytes ``prepare_mode_tensor`` holds for mode ``mode`` of a 3-D
    tensor of ``shape`` whose elements take ``itemsize`` bytes."""
    small, big = split_others(tuple(shape), mode)
    j, i, k = shape[small], shape[mode], shape[big]
    if precision == "highest":
        return j * k * padded_i(i) * itemsize
    return PLANES[precision] * j * i * padded_k(k) * 2


def mode_layout(x: torch.Tensor, mode: int) -> torch.Tensor:
    """X's own ``[J, I, K]`` view of mode ``mode`` (the TPU kernel's layout)."""
    small, big = split_others(tuple(x.shape), mode)
    return x.permute(small, mode, big)


def prepare_mode_tensor(x: torch.Tensor, mode: int, precision: str = "highest") -> torch.Tensor:
    """The tier's held layout of mode ``mode`` (module docstring): one copy
    of X, two bf16 planes at ``"high"``."""
    if precision not in TIERS:
        raise ValueError(f"precision {precision!r}")
    if precision == "highest":
        small, big = split_others(tuple(x.shape), mode)
        xk = x.permute(small, big, mode)
        j, k, i = xk.shape
        held = xk.new_zeros((j, k, padded_i(i)))
        held[..., :i] = xk
        return held[..., :i]
    x3 = mode_layout(x, mode)
    x3 = torch.nn.functional.pad(x3, (0, padded_k(x3.shape[2]) - x3.shape[2]))
    hi = x3.to(torch.bfloat16).contiguous()
    if precision == "default":
        return hi
    lo = (x3 - hi.to(x3.dtype)).to(torch.bfloat16)  # x - hi is exact
    return torch.stack((hi, lo))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _x_planes(x3: torch.Tensor, k: int, precision: str, dtype) -> list[torch.Tensor]:
    """The tier's rounded X planes ``[J, I, K]`` in ``dtype``: read from the
    held bf16 layout, or rounded here from X's own layout (same values)."""
    if x3.dtype == torch.bfloat16:
        planes = x3 if precision == "high" else x3[None]
        return [p[..., :k].to(dtype).contiguous() for p in planes]
    xh = _bf16(x3)
    return [xh, _bf16(x3 - xh)] if precision == "high" else [xh]


def fused_mttkrp_plain(
    x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, precision: str
) -> torch.Tensor:
    """Plain PyTorch version: ``w_j = X_j @ U2`` per j, with the tier's
    bf16 rounding emulated in the working dtype, then ``sum_j w_j * U1[j]``.
    ``x3`` is the tier's held layout (``[J, K, I]`` at "highest") or, at the
    bf16 tiers, also X's own ``[J, I, K]`` layout; both give bit-identical
    results."""
    b, j, r = u1.shape
    k = u2.shape[1]
    u2p = u2.permute(1, 0, 2).reshape(k, b * r)
    if precision == "highest":
        w = torch.matmul(x3.transpose(1, 2), u2p)
    elif precision in PLANES:
        xs = _x_planes(x3, k, precision, u2.dtype)
        uh = _bf16(u2p)
        w = torch.matmul(xs[0], uh)
        if precision == "high":
            w = w + torch.matmul(xs[0], _bf16(u2p - uh))
            w = w + torch.matmul(xs[1], uh)
    else:
        raise ValueError(f"precision {precision!r}")
    i = w.shape[1]
    u1p = u1.permute(1, 0, 2).reshape(j, b * r)
    g = (w * u1p[:, None, :]).sum(0)  # [I, B*R]
    return g.reshape(i, b, r).permute(1, 0, 2).contiguous()


def fp32_smem(tile: int, kspan: int) -> int:
    """Shared memory of one fp32 block (csrc/fused_mttkrp.cu: smem_bytes):
    the U2 slice [kspan, 128] and the X ring [4, groups, 16, rows], fp32,
    or the groups' sums [groups, rows, 128] where larger; then one 8-byte
    mbarrier per ring stage."""
    tm, _, _, ng = FP32_TILES[tile]
    main = kspan * _TN + _FP32_STAGES * ng * _FP32_TK * tm
    return 4 * max(main, ng * tm * _TN) + 8 * _FP32_STAGES


def plan_fp32(
    j: int, i: int, k: int, c: int, n_sm: int, smem_block: int,
    tiles: dict | None = None, smem=fp32_smem,
) -> tuple[int, ...]:
    """(tile, k per block, k splits, j splits, j per split) of the fp32
    kernel on a card of ``n_sm`` SMs and ``smem_block`` bytes of shared
    memory per block, for the tile table ``tiles`` (``FP32_TILES`` when
    None) and its shared memory ``smem(tile, kspan)``. The tile is the one
    with the fewest padded rows. K is split into the fewest ranges (of
    whole 16-k stages) whose U2 slice fits in shared memory, one range in
    all but very long modes. Then j is split into as many parts as keep the
    grid within one wave (one block per SM: the U2 slice fills its shared
    memory), each of as few rounds (``fp32_rounds``) as that allows."""
    tiles = FP32_TILES if tiles is None else tiles
    tile = min(tiles, key=lambda t: (-(-i // tiles[t][0]) * tiles[t][0], -tiles[t][0]))
    tm, ng = tiles[tile][0], tiles[tile][3]
    chunks = max(1, -(-k // _FP32_TK))
    for ksplits in range(1, chunks + 1):
        kspan = -(-chunks // ksplits) * _FP32_TK
        if smem(tile, kspan) <= smem_block:
            break
    else:
        raise ValueError("fused_mttkrp: one 16-k range of U2 does not fit in shared memory")
    ksplits = max(1, -(-k // kspan))  # no empty range
    tiles_n = -(-c // _TN) * -(-i // tm) * ksplits
    want = max(1, min(j, n_sm // tiles_n))
    # The fewest rounds per block within one wave; of equals, the longest j
    # range (the fewest splits).
    jchunk = min(range(-(-j // want), j + 1), key=lambda n: (fp32_rounds(n, ng), -n))
    return tile, kspan, ksplits, max(1, -(-j // jchunk)), jchunk


def fp32_rounds(nj: int, ng: int) -> float:
    """Rounds of k stages a block of the fp32 kernel with ``ng`` j groups
    takes for ``nj`` j: whole rounds of one j per group, and where the last
    round has r < ng j with r dividing ng, a split round of 1 / (ng / r)
    (csrc/fused_mttkrp.cu: mttkrp_kernel)."""
    rem = nj % ng
    if rem and ng % rem == 0:
        return nj // ng + rem / ng
    return -(-nj // ng)


@functools.lru_cache(maxsize=None)
def fp32_tiles_built() -> dict:
    """The tile table of the built fp32 kernel (its ``FP32_TILES``), read
    from the library."""
    lib = _lib_fp32()
    tiles, shape = {}, (ctypes.c_int * 4)()
    for tid in range(16):
        if lib.fused_mttkrp_fp32_tile(tid, shape) == 0:
            tiles[tid] = tuple(shape)
    return tiles


@functools.lru_cache(maxsize=None)
def fp32_plan(index: int, j: int, i: int, k: int, c: int) -> tuple[int, ...]:
    """``plan_fp32`` for card ``index`` (its properties read once), with the
    built kernel's own tile table and shared-memory sizes."""
    props = torch.cuda.get_device_properties(index)
    return plan_fp32(j, i, k, c, props.multi_processor_count, props.shared_memory_per_block_optin,
                     fp32_tiles_built(), _lib_fp32().fused_mttkrp_fp32_smem)


def _check_splits(name: str, n: int, span: int, splits: int) -> None:
    """``splits`` ranges of ``span`` cover ``n`` with no empty range."""
    if span < 1 or splits < 1 or splits * span < n or (splits - 1) * span >= max(n, 1):
        raise ValueError(f"fused_mttkrp plan: {splits} {name} ranges of {span} do not cover {name} = {n} "
                         f"with none empty")


def _check_plan(plan, stage: int, j: int, i: int, k: int, tm: int, smem: int, smem_block: int) -> tuple:
    tile, kspan, ksplits, jsplits, jchunk = plan
    if kspan % stage:
        raise ValueError(f"fused_mttkrp plan {plan}: k per block {kspan} is not a multiple of the stage {stage}")
    _check_splits("K", k, kspan, ksplits)
    _check_splits("J", j, jchunk, jsplits)
    if smem > smem_block:
        raise ValueError(f"fused_mttkrp plan {plan}: {smem} bytes of shared memory, above the "
                         f"{smem_block} a block may have")
    if -(-i // tm) > _GRID_YZ or ksplits * jsplits > _GRID_YZ:
        raise ValueError(f"fused_mttkrp plan {plan}: a grid of {-(-i // tm)} row tiles and "
                         f"{ksplits * jsplits} splits is beyond the launch limit {_GRID_YZ}")
    return plan


def _as_plan(plan) -> tuple:
    try:
        out = tuple(int(v) for v in plan)
    except (TypeError, ValueError):
        out = ()
    if len(out) != 5 or out != tuple(plan):
        raise ValueError(f"fused_mttkrp plan {plan!r}: five integers expected")
    return out


def check_fp32_plan(plan, j: int, i: int, k: int, smem_block: int, tiles: dict | None = None,
                    smem=fp32_smem) -> tuple:
    """``plan`` (tile, k per block, k splits, j splits, j per split) of the
    fp32 kernel for X [J, K, I] on a card of ``smem_block`` bytes of shared
    memory per block, the tile table ``tiles`` (``FP32_TILES`` when None)
    and its shared memory ``smem(tile, kspan)``, as a tuple; raises
    ``ValueError`` unless the tile is in the table, the k per block is
    whole 16-k stages, the k ranges cover K and the j ranges J with none
    empty, the block's shared memory fits, and the grid's row tiles and
    splits stay within its y and z limits."""
    tiles = FP32_TILES if tiles is None else tiles
    plan = _as_plan(plan)
    if plan[0] not in tiles:
        raise ValueError(f"fused_mttkrp plan {plan}: tile {plan[0]} is not one of the built tiles {sorted(tiles)}")
    return _check_plan(plan, _FP32_TK, j, i, k, tiles[plan[0]][0], smem(plan[0], plan[1]), smem_block)


def _check_factors(name, dev, u1, u2, j):
    b, j1, r = u1.shape
    for tname, t in (("u1", u1), ("u2", u2)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {tname} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: {tname} must be contiguous on {dev}")
    if j1 != j or u2.dim() != 3 or u2.shape[0] != b or u2.shape[2] != r:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)}, u2 {tuple(u2.shape)} do not agree with J = {j}")


def _split_work(dev, splits: int, i: int, c: int):
    return torch.empty((splits, i, c), dtype=torch.float32, device=dev) if splits > 1 else None


def _check_pred(name, dev, pred):
    if pred is not None and (pred.dtype != torch.int32 or pred.numel() != 1 or pred.device != dev):
        raise ValueError(f"{name}: pred must be a one-element int32 tensor on {dev}")


@functools.cache  # once: concurrent first calls would race on the argtypes
def _lib_fp32():
    lib = _build.load("fused_mttkrp.cu")
    if lib.fused_mttkrp_launch.argtypes is None:
        lib.fused_mttkrp_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
        lib.fused_mttkrp_launch.restype = ctypes.c_int
        lib.fused_mttkrp_fp32_tile.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.fused_mttkrp_fp32_tile.restype = ctypes.c_int
        lib.fused_mttkrp_fp32_smem.argtypes = [ctypes.c_int] * 2
        lib.fused_mttkrp_fp32_smem.restype = ctypes.c_longlong
    return lib


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


@launches.wrapper(predicated=True)
def fused_mttkrp_fp32(
    x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, pred: torch.Tensor | None = None,
    plan=None,
) -> torch.Tensor:
    """The "highest" tier: x3 the held float32 [J, K, I] layout (rows of
    stride Ip, a multiple of 4), u1 [B, J, R], u2 [B, K, R] -> G [B, I, R],
    on the CUDA cores; ``pred`` and ``plan`` as in the module docstring."""
    dev = x3.device
    if dev.type == "cpu":
        return fused_mttkrp_plain(x3, u1, u2, "highest")
    if dev.type != "cuda":
        raise ValueError(f"fused_mttkrp: unsupported device {dev}")
    if x3.dtype != torch.float32 or x3.dim() != 3:
        raise ValueError(f"fused_mttkrp: x3 must be the held float32 [J, K, I], got {x3.dtype} {tuple(x3.shape)}")
    j, k, i = x3.shape
    ip = x3.stride(1)
    if (x3.stride(2) != 1 or ip < i or ip % 4 or x3.stride(0) != k * ip or x3.data_ptr() % 16
            or x3.untyped_storage().nbytes() < 4 * (x3.storage_offset() + j * k * ip)):
        raise ValueError(
            f"fused_mttkrp: at precision 'highest' x3 must be the held layout [J, K, I], 16-byte "
            f"aligned, rows of stride Ip (a multiple of 4, >= I) in a [J, K, Ip] block; got "
            f"shape {tuple(x3.shape)} strides {x3.stride()}"
        )
    _check_factors("fused_mttkrp", dev, u1, u2, j)
    _check_pred("fused_mttkrp", dev, pred)
    b, _, r = u1.shape
    if u2.shape[1] != k:
        raise ValueError(f"fused_mttkrp: x3 {tuple(x3.shape)} and u2 {tuple(u2.shape)} do not agree")
    out = torch.empty((b, i, r), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    index = _device_index(dev)
    if plan is None:
        plan = fp32_plan(index, j, i, k, b * r)
    else:
        plan = check_fp32_plan(plan, j, i, k, _smem_optin(index), fp32_tiles_built(),
                               _lib_fp32().fused_mttkrp_fp32_smem)
    tile, kspan, ksplits, jsplits, jchunk = plan
    work = _split_work(dev, ksplits * jsplits, i, b * r)
    code = _lib_fp32().fused_mttkrp_launch(
        x3.data_ptr(), u1.data_ptr(), u2.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        j, i, ip, k, b, r, tile, kspan, ksplits, jsplits, jchunk,
        pred.data_ptr() if pred is not None else None, _build.stream_ptr(dev),
    )
    _build.check(code, "fused_mttkrp")
    fused_mttkrp_fp32.count(pred is not None)
    return out


@functools.cache
def _lib_tc():
    lib = _build.load("fused_mttkrp_tc.cu")
    if lib.fused_mttkrp_tc_launch.argtypes is None:
        lib.fused_mttkrp_tc_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2
        lib.fused_mttkrp_tc_launch.restype = ctypes.c_int
        lib.fused_mttkrp_tc_smem.argtypes = [ctypes.c_int] * 3
        lib.fused_mttkrp_tc_smem.restype = ctypes.c_longlong
    return lib


def tc_smem(nc: int, high: bool, kspan: int) -> int:
    """Shared memory of one tensor-core block (csrc/fused_mttkrp_tc.cu:
    smem_bytes): the resident U2 slice [kspan, nc] and the X ring of
    stages [64, 64], bf16, a plane each (two at "high"), then per stage
    the U1 row [nc] fp32 and an mbarrier pair. A ``cuda`` test holds it
    equal to the library's."""
    stages = 4 if high else 8
    return 2 * (2 if high else 1) * (nc * -(-kspan // _TC_KS) * _TC_KS + stages * _TC_TM * _TC_KS) + stages * (
        4 * nc + 16)


def tc_waves(plan, i: int, c: int, slots: int) -> int:
    """Waves of the tensor-core kernel's grid under ``plan`` for I = ``i``
    and ``c`` columns on a card of ``slots`` block slots (blocks that run
    at once)."""
    nc, _, ksplits, jsplits, _ = plan
    return -(-(-(-c // nc) * -(-i // _TC_TM) * ksplits * jsplits) // slots)


def tc_cost(plan, i: int, c: int, slots: int) -> int:
    """Ring stages of the busiest block slot under tensor-core ``plan``,
    each wave counted as its longest block (j per split times the stages of
    a k range) plus what a block costs besides (``_TC_BLOCK_STAGES``)."""
    return tc_waves(plan, i, c, slots) * (plan[4] * (plan[1] // _TC_KS) + _TC_BLOCK_STAGES)


def tc_slots(nc: int, planes: int, kspan: int, n_sm: int, smem_sm: int, smem=tc_smem) -> int:
    """Blocks of this column tile and k range that run at once on a card
    of ``n_sm`` SMs of ``smem_sm`` bytes of shared memory each."""
    return max(1, smem_sm // (smem(nc, planes - 1, kspan) + 1024)) * n_sm


def split_j(head: tuple, j: int, want: int) -> tuple:
    """``head`` (column tile, k per block, k splits) with j split into
    ``want`` parts as nearly equal as whole parts allow."""
    jchunk = -(-j // want)
    return head + (-(-j // jchunk), jchunk)


def one_wave_tc(head: tuple, j: int, i: int, c: int, slots: int) -> tuple:
    """``head`` with j split into as many parts as keep the grid within
    one wave of ``slots`` blocks: every block then runs at once."""
    tiles = -(-c // head[0]) * -(-i // _TC_TM) * head[2]
    return split_j(head, j, max(1, min(j, slots // tiles)))


def plan_tc(
    j: int, i: int, kp: int, c: int, planes: int, n_sm: int, smem_block: int, smem_sm: int,
    smem=tc_smem,
) -> tuple[int, ...]:
    """(column tile, k per block, k splits, j splits, j per split) of the
    tensor-core kernel on a card of ``n_sm`` SMs, ``smem_block`` bytes of
    shared memory per block and ``smem_sm`` per SM, for the kernel's shared
    memory ``smem(nc, high, kspan)``. K is split into the fewest ranges
    (of whole 64-k chunks) for which some tile's resident U2 slice fits in
    shared memory, one range in all but very long modes. The tile is the
    narrowest that covers all C columns, else the widest that fits. Then j
    is split into as many parts as keep the grid within one wave (as many
    blocks per SM as fit in its shared memory), unless more parts over
    more waves cost less than ``_TC_MARGIN`` of that (``tc_cost``): then
    the cheapest such split, the fewest parts of equals."""
    chunks = max(1, -(-kp // _TC_KS))
    for ksplits in range(1, chunks + 1):
        kspan = -(-chunks // ksplits) * _TC_KS
        fits = [nc for nc in _TC_NC if smem(nc, planes - 1, kspan) <= smem_block]
        if fits:
            break
    else:
        raise ValueError("fused_mttkrp: one 64-k range of U2 does not fit in shared memory")
    ksplits = -(-chunks * _TC_KS // kspan)  # no empty range
    covering = [nc for nc in fits if nc >= c]
    nc = covering[-1] if covering else fits[0]
    slots = tc_slots(nc, planes, kspan, n_sm, smem_sm, smem)
    plan = one_wave_tc((nc, kspan, ksplits), j, i, c, slots)
    best, cost = plan, tc_cost(plan, i, c, slots)
    for want in range(plan[3] + 1, j + 1):
        split = split_j(plan[:3], j, want)
        if tc_waves(split, i, c, slots) * _TC_BLOCK_STAGES >= cost:
            break  # the waves alone cost more from here on
        if tc_cost(split, i, c, slots) < cost:
            best, cost = split, tc_cost(split, i, c, slots)
    return best if cost < _TC_MARGIN * tc_cost(plan, i, c, slots) else plan


@functools.lru_cache(maxsize=None)
def tc_plan(index: int, j: int, i: int, kp: int, c: int, planes: int) -> tuple[int, ...]:
    """``plan_tc`` for card ``index`` (its properties read once), with the
    built kernel's own shared-memory sizes."""
    props = torch.cuda.get_device_properties(index)
    return plan_tc(j, i, kp, c, planes, props.multi_processor_count, props.shared_memory_per_block_optin,
                   props.shared_memory_per_multiprocessor, _lib_tc().fused_mttkrp_tc_smem)


@functools.lru_cache(maxsize=None)
def _tc_slots(index: int, nc: int, planes: int, kspan: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return tc_slots(nc, planes, kspan, props.multi_processor_count, props.shared_memory_per_multiprocessor,
                    _lib_tc().fused_mttkrp_tc_smem)


def check_tc_plan(plan, j: int, i: int, kp: int, planes: int, smem_block: int, smem=tc_smem) -> tuple:
    """``plan`` (column tile, k per block, k splits, j splits, j per split)
    of the tensor-core kernel for X [J, I, Kp] of ``planes`` bf16 planes,
    as ``check_fp32_plan`` checks a plan of the fp32 kernel: the column
    tile is one of ``_TC_NC`` and the k per block whole 64-k stages."""
    plan = _as_plan(plan)
    if plan[0] not in _TC_NC:
        raise ValueError(f"fused_mttkrp plan {plan}: column tile {plan[0]} is not one of {_TC_NC}")
    return _check_plan(plan, _TC_KS, j, i, kp, _TC_TM, smem(plan[0], planes - 1, plan[1]), smem_block)


@launches.wrapper(predicated=True)
def fused_mttkrp_tc(
    x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, precision: str,
    pred: torch.Tensor | None = None, plan=None,
) -> torch.Tensor:
    """The bf16 tiers: x3 the held layout (bf16 [J, I, Kp] at "default",
    [2, J, I, Kp] at "high"), u1 [B, J, R], u2 [B, K, R] -> G [B, I, R], on
    the tensor cores; ``pred`` and ``plan`` as in the module docstring."""
    dev = x3.device
    if dev.type == "cpu":
        return fused_mttkrp_plain(x3, u1, u2, precision)
    if dev.type != "cuda":
        raise ValueError(f"fused_mttkrp: unsupported device {dev}")
    if precision not in PLANES:
        raise ValueError(f"fused_mttkrp_tc: precision {precision!r} is not a bf16 tier")
    planes = PLANES[precision]
    lead = (2,) if planes == 2 else ()
    b, j, r = u1.shape
    k = u2.shape[1] if u2.dim() == 3 else -1
    if (x3.dtype != torch.bfloat16 or x3.dim() != len(lead) + 3
            or tuple(x3.shape[: len(lead) + 1]) != lead + (j,) or x3.shape[-1] != padded_k(k)
            or not x3.is_contiguous() or x3.data_ptr() % 16):
        raise ValueError(
            f"fused_mttkrp: at precision {precision!r} x3 must be the held layout, contiguous "
            f"16-byte-aligned bfloat16 {list(lead) + ['J', 'I', 'Kp']} with J = {j}, Kp = "
            f"{padded_k(k)}; got {x3.dtype} {tuple(x3.shape)}"
        )
    _check_factors("fused_mttkrp", dev, u1, u2, j)
    _check_pred("fused_mttkrp_tc", dev, pred)
    i, kp = x3.shape[-2], x3.shape[-1]
    out = torch.empty((b, i, r), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    index = _device_index(dev)
    if plan is None:
        plan = tc_plan(index, j, i, kp, b * r, planes)
    else:
        plan = check_tc_plan(plan, j, i, kp, planes, _smem_optin(index), _lib_tc().fused_mttkrp_tc_smem)
    nc, kspan, ksplits, jsplits, jchunk = plan
    work = _split_work(dev, ksplits * jsplits, i, b * r)
    code = _lib_tc().fused_mttkrp_tc_launch(
        x3.data_ptr(), u1.data_ptr(), u2.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        j, i, k, kp, b, r, planes - 1, nc, kspan, ksplits, jsplits, jchunk,
        pred.data_ptr() if pred is not None else None, _build.stream_ptr(dev),
    )
    _build.check(code, "fused_mttkrp_tc")
    fused_mttkrp_tc.count(pred is not None)
    if jsplits > 1 and tc_waves(plan, i, b * r, _tc_slots(index, nc, planes, kspan)) > 1:
        # In a capture only on the tally: the graph adds the recorder's count at each replay.
        BALANCED.add("tc_balanced")
        if not torch.cuda.is_current_stream_capturing():
            timers.count("mttkrp.tc_balanced")
    return out


_GRID_YZ = 65535  # the largest grid y and z of a launch (row tiles; k and j splits)


def fused_mttkrp_supported(shape, mode: int, b: int, r: int, dtype, device) -> bool:
    """Whether the fused kernels take mode ``mode`` of a tensor of ``shape``
    with ``b`` models of rank ``r`` (the port's counterpart of
    ``cp_cals_tpu/ops/pallas_mttkrp.py:62 pallas_mttkrp_supported``),
    decided from shapes and dtype before any launch. On the CPU, where the
    plain version takes every 3-D shape: 3-D. On the card: 3-D, float32,
    and both kernels (the tier is not an argument) plan the mode: one k
    range of U2 fits a block's shared memory (where ``plan_fp32`` and
    ``tc_plan`` would raise otherwise) and the grid's row tiles and splits
    stay within its y and z limits. ``mttkrp_batched`` sends a mode it
    refuses to the twostep."""
    dev = torch.device(device)
    if len(shape) != 3:
        return False
    if dev.type == "cpu":
        return True
    if dev.type != "cuda" or dtype != torch.float32:
        return False
    return _card_takes(tuple(int(n) for n in shape), mode, int(b), int(r), _device_index(dev))


@functools.lru_cache(maxsize=None)
def _card_takes(shape: tuple, mode: int, b: int, r: int, index: int) -> bool:
    small, big = split_others(shape, mode)
    j, i, k = shape[small], shape[mode], shape[big]
    if min(j, i, k, b, r) < 1:
        return True  # an empty output: the wrappers launch nothing
    optin = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    tiles = fp32_tiles_built()
    tile = min(tiles, key=lambda t: (-(-i // tiles[t][0]) * tiles[t][0], -tiles[t][0]))
    tc_smem = _lib_tc().fused_mttkrp_tc_smem
    if (_lib_fp32().fused_mttkrp_fp32_smem(tile, _FP32_TK) > optin
            or not any(tc_smem(nc, 1, _TC_KS) <= optin for nc in _TC_NC)):
        return False
    _, _, ks, js, _ = fp32_plan(index, j, i, k, b * r)
    _, _, ks2, js2, _ = tc_plan(index, j, i, padded_k(k), b * r, 2)
    return (max(-(-i // tiles[tile][0]), -(-i // _TC_TM)) <= _GRID_YZ
            and max(ks * js, ks2 * js2) <= _GRID_YZ)


def fused_mttkrp(
    x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
    precision: str = "highest", pred: torch.Tensor | None = None, plan=None,
) -> torch.Tensor:
    """x3 the tier's held layout (``prepare_mode_tensor``), u1 [B, J, R],
    u2 [B, K, R] -> G [B, I, R], through the tier's kernel (``plan``: that
    kernel's, or None for the planner's)."""
    if precision == "highest":
        return fused_mttkrp_fp32(x3, u1, u2, pred, plan)
    return fused_mttkrp_tc(x3, u1, u2, precision, pred, plan)


def mttkrp_batched_fused(
    x: torch.Tensor, factors, mode: int,
    prepared: torch.Tensor | None = None, precision: str = "highest",
    pred: torch.Tensor | None = None, plan=None,
) -> torch.Tensor:
    """Batched fused MTTKRP. factors: per-mode [B, I_m, R]; returns
    [B, I_mode, R]. ``prepared`` is ``prepare_mode_tensor(x, mode,
    precision)``; ``plan`` the tier's kernel's, or None for the planner's."""
    small, big = split_others(tuple(x.shape), mode)
    x3 = prepared if prepared is not None else prepare_mode_tensor(x, mode, precision)
    return fused_mttkrp(x3, factors[small], factors[big], precision, pred, plan)
