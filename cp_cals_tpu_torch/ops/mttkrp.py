"""MTTKRP methods, dispatch and FLOP accounting (port of
``cp_cals_tpu/ops/mttkrp.py``).

- ``krp_gemm``: the Khatri-Rao product of the non-target factors, then one
  matrix product with the mode-n unfolding.
- ``twostep``: contract the largest non-target mode with one matrix product
  (the TTM), then each remaining mode by a per-column contraction (TTV),
  largest first; any N.
- ``pallas``: the hand-written fused 3-D kernels (``ops/fused_mttkrp.py``,
  kept under the JAX package's name); a mode its static gate
  (``fused_mttkrp_supported``) refuses, and every mode of a tensor that is
  not 3-D, takes the twostep, as in the JAX package.
- the dimension tree (3-D): modes 1 and 2 both come from one shared TTM
  ``X x_0 A`` after the mode-0 update (``dimtree_ttm``, ``dimtree_ttv``).

Batched forms take factors ``[B, I_m, R]`` and pack all models' columns
into ``C = B*R`` columns of one product. Every product here goes through
``tier_matmul``, the tier rule of the port: ``"highest"`` is the strict
working-dtype product (TF32 off, ``device.py``); ``"default"`` one product
of the bf16 roundings of both operands; ``"high"`` three, hi*hi + hi*lo +
lo*hi, added in that order. The products of bf16 values are exact and
summed in float32 or wider, as the fused kernels' plain version emulates
(``ops/fused_mttkrp.py:fused_mttkrp_plain``).

``ROUTES`` counts the MTTKRP results by route, each one mode of one batched
call (``launches.py`` carries the counts across CUDA-graph replays).
``LAYOUTS`` counts the layouts a batched MTTKRP derives from X where it is
given none held (``mode_layouts="recompute"``, which ``"auto"`` takes where
the held layouts would not fit the device's budget:
``config.resolve_layouts``), and the bytes they take,
the same way; while the recorder is on (``utils/timers.py``) they also
count as ``layouts.derived`` and ``layouts.derived_bytes``, which a CUDA
graph's replay adds in ``solvers/graph_loop.Graph``. A layout that is a
view of X (mode 0's unfolding) is no copy and not counted.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..launches import Tally
from ..utils import timers
from .fused_mttkrp import fused_mttkrp_supported, mttkrp_batched_fused, prepare_mode_tensor
from .khatri_rao import khatri_rao_chain

PRECISIONS = ("highest", "high", "default")
# bf16 twostep intermediate at the "default" tier (mttkrp_batched_twostep),
# as the JAX package's TS_COMPACT_INTERMEDIATE.
TS_COMPACT_INTERMEDIATE: bool = True
ROUTES = Tally(fixed=("fused", "twostep", "krp_gemm", "dimtree"))  # MTTKRP results by route
LAYOUTS = Tally(fixed=("derived", "derived_bytes"))  # layouts derived inside the iteration


def _others(n_modes: int, mode: int) -> list[int]:
    return [m for m in range(n_modes) if m != mode]


def _unfold(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n unfolding [I_n, prod(I_m, m != n)], remaining modes in
    ascending order (the layout ``khatri_rao_chain`` matches)."""
    return x.permute(mode, *_others(x.ndim, mode)).reshape(x.shape[mode], -1)


# ------------------------------------------------------------- the tier rule


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _on_tensor_cores(a: torch.Tensor) -> bool:
    """float32 (or already bf16) operands on the card: the bf16 products
    run as cuBLAS bf16 GEMMs with float32 output."""
    return a.is_cuda and a.dtype in (torch.float32, torch.bfloat16)


def tier_matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest",
                out_dtype=None) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) under the tier rule (module
    docstring). On the card float32 operands go to cuBLAS as bf16 with
    float32 output (``torch.mm``/``torch.bmm`` ``out_dtype``); elsewhere
    (the CPU, float64) the same exact products of the rounded values run in
    the working dtype. The two differ in summation order only.

    ``out_dtype=torch.bfloat16`` (the twostep's compact intermediate) rounds
    the result to bf16: on the card one bf16 GEMM with a bf16 output and
    float32 accumulation, elsewhere the rounded values in the working
    dtype. A bf16 operand counts as already rounded (its lo part is 0)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {PRECISIONS}")
    if precision == "highest":
        return torch.matmul(a, b)
    if _on_tensor_cores(a):
        mm = torch.mm if a.dim() == 2 else torch.bmm
        ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if precision == "default" and out_dtype == torch.bfloat16:
            return mm(ah, bh)
        out = mm(ah, bh, out_dtype=torch.float32)
        if precision == "high":
            if b.dtype != torch.bfloat16:
                out = out + mm(ah, (b - bh.float()).to(torch.bfloat16), out_dtype=torch.float32)
            if a.dtype != torch.bfloat16:
                out = out + mm((a - ah.float()).to(torch.bfloat16), bh, out_dtype=torch.float32)
        return out.to(torch.bfloat16) if out_dtype == torch.bfloat16 else out
    ah, bh = _bf16(a), _bf16(b)
    out = torch.matmul(ah, bh)
    if precision == "high":
        out = out + torch.matmul(ah, _bf16(b - bh))
        out = out + torch.matmul(_bf16(a - ah), bh)
    return _bf16(out) if out_dtype == torch.bfloat16 else out


def _ttv(tb: torch.Tensor, u: torch.Tensor, ax: int, precision: str, out_dtype=None) -> torch.Tensor:
    """Contract axis ``ax`` of the column-first tensor ``tb`` [C, d1, ..., dk]
    with ``u`` [d_ax, C], elementwise in C: one batched product per column
    (``tier_matmul``). Returns [C, d1, ..(without d_ax).., dk]."""
    c, s = tb.shape[0], tb.shape[ax]
    rest = tb.shape[1:ax] + tb.shape[ax + 1:]
    a = tb.movedim(ax, -1).reshape(c, -1, s)
    out = tier_matmul(a, u.t().reshape(c, s, 1), precision, out_dtype)
    return out.reshape(c, *rest)


def layout_bytes(x: torch.Tensor, layout: torch.Tensor) -> int:
    """The bytes ``layout``, a layout of ``x``, holds: its storage's, or 0
    where it is a view of ``x``."""
    st = layout.untyped_storage()
    return 0 if st.data_ptr() == x.untyped_storage().data_ptr() else st.nbytes()


def _derived(x: torch.Tensor, layout: torch.Tensor) -> torch.Tensor:
    """``layout``, derived from ``x`` inside the iteration, counted (module
    docstring). Inside a capture only ``LAYOUTS`` counts: the graph adds
    the recorder's counts at each replay."""
    n = layout_bytes(x, layout)
    if n:
        LAYOUTS.add("derived")
        LAYOUTS.add("derived_bytes", n)
        if not (layout.is_cuda and torch.cuda.is_current_stream_capturing()):
            timers.count("layouts.derived")
            timers.count("layouts.derived_bytes", n)
    return layout


# ------------------------------------------------------------ single model


def mttkrp_krp_gemm(x: torch.Tensor, factors, mode: int, precision: str = "highest") -> torch.Tensor:
    """G = X_(n) @ KRP(others): one product."""
    krp = khatri_rao_chain([factors[m] for m in _others(x.ndim, mode)])  # [P, R]
    return tier_matmul(_unfold(x, mode), krp, precision)


def mttkrp_twostep(x: torch.Tensor, factors, mode: int, precision: str = "highest") -> torch.Tensor:
    """Single-factor contractions, the largest mode first, ties toward the
    highest index: the batched twostep's order on a batch of one, so the
    single-model and batched twosteps share their reduction order."""
    return mttkrp_batched_twostep(x, [f[None] for f in factors], mode, precision)[0]


def mttkrp(x: torch.Tensor, factors, mode: int, method: str = "krp_gemm",
           precision: str = "highest") -> torch.Tensor:
    if method in ("krp_gemm", "auto"):
        return mttkrp_krp_gemm(x, factors, mode, precision)
    if method == "twostep":
        return mttkrp_twostep(x, factors, mode, precision)
    raise ValueError(f"unknown mttkrp method {method!r}")


# ------------------------------------------------------------- batched forms


def prepare_unfoldings(x: torch.Tensor) -> tuple:
    """Every mode-n unfolding, once (N copies of X)."""
    return tuple(_unfold(x, n).contiguous() for n in range(x.ndim))


def resolve_batched_method(method: str, shape, mode: int, dtype, device, b: int = 1, r: int = 1) -> str:
    """The method a batched MTTKRP of ``mode`` runs: ``"pallas"`` where the
    fused kernels' static gate takes the mode (always 3-D), else the
    twostep, as the JAX package sends N-D tensors and the modes its gate
    refuses to the twostep."""
    if method == "pallas" and not fused_mttkrp_supported(tuple(shape), mode, b, r, dtype, device):
        return "twostep"
    if method not in ("pallas", "twostep", "krp_gemm", "auto"):
        raise ValueError(f"unknown mttkrp method {method!r}")
    return method


def prepare_mode(x: torch.Tensor, mode: int, method: str, precision: str = "highest") -> torch.Tensor:
    """The loop-invariant layout of one mode for ``method`` (already
    resolved), an |X|-sized copy: the unfolding for ``krp_gemm``, the
    twostep's ``[I_n * prod(small), I_big]``, the fused kernels' held layout
    at the MTTKRP tier ``precision`` (X rounded there, once)."""
    if method in ("krp_gemm", "auto"):
        return _unfold(x, mode).contiguous()
    if method == "twostep":
        return _ts_layout(x, mode)
    return prepare_mode_tensor(x, mode, precision)


def prepare_batched(x: torch.Tensor, methods: Sequence[str], precision: str = "highest") -> tuple:
    """Every mode's ``prepare_mode`` layout for the chosen methods. The
    fused gate's planners refuse a mode by its k range alone, so the gate
    is asked here for one model of rank one."""
    return tuple(prepare_mode(x, n, resolve_batched_method(m, x.shape, n, x.dtype, x.device), precision)
                 for n, m in enumerate(methods))


def _packed_krp(factors_t: list[torch.Tensor]) -> torch.Tensor:
    """KRP chain built in the packed [P, B*R] layout from factors
    pre-transposed to [I_m, B, R]: every step writes (B, R) as the minor
    dims, so the KRP is written once in the layout the product reads."""
    out = factors_t[0]
    for f in factors_t[1:]:
        p1, b, r = out.shape
        out = (out[:, None] * f[None]).reshape(p1 * f.shape[0], b, r)
    p, b, r = out.shape
    return out.reshape(p, b * r)


def mttkrp_batched_krp(x: torch.Tensor, factors, mode: int, precision: str = "highest",
                       prepared: torch.Tensor | None = None) -> torch.Tensor:
    """[B, I_n, R] through one [I_n, P] x [P, B*R] product."""
    others = _others(x.ndim, mode)
    b, _, r = factors[others[0]].shape
    krp2 = _packed_krp([factors[m].permute(1, 0, 2) for m in others])
    xu = prepared if prepared is not None else _unfold(x, mode)
    g = tier_matmul(xu, krp2, precision)  # [I_n, B*R]
    return g.reshape(x.shape[mode], b, r).permute(1, 0, 2).contiguous()


def _ts_big(x_shape, others) -> int:
    """The mode the twostep contracts first: the largest non-target mode,
    ties toward the HIGHEST index (the JAX package's choice)."""
    return max(others, key=lambda m: (x_shape[m], m))


def _ts_layout(x: torch.Tensor, mode: int) -> torch.Tensor:
    """The twostep's tensor layout: [I_n * prod(small), I_big]."""
    others = _others(x.ndim, mode)
    big = _ts_big(x.shape, others)
    small = [m for m in others if m != big]
    return x.permute(mode, *small, big).reshape(-1, x.shape[big])


def mttkrp_batched_twostep(x: torch.Tensor, factors, mode: int, precision: str = "highest",
                           prepared: torch.Tensor | None = None) -> torch.Tensor:
    """Packed TTM + TTVs: the largest non-target mode in ONE product into a
    [I_n * prod(small), B*R] intermediate, then each remaining mode by a
    per-column contraction, the largest first (ties toward the highest
    index), down to [B, I_n, R]. At "default" the intermediates are bf16
    (``TS_COMPACT_INTERMEDIATE``): the TTM's products are bf16 already, and
    a bf16 intermediate halves its memory traffic; the last TTV writes the
    working dtype. The JAX package compacts float32 only; the port rounds
    the intermediates at every working dtype (``tier_matmul``), so that a
    float64 run repeats the card's rounding steps."""
    others = _others(x.ndim, mode)
    big = _ts_big(x.shape, others)
    small = [m for m in others if m != big]
    b, _, r = factors[big].shape
    i_n, i_b = x.shape[mode], x.shape[big]
    compact = TS_COMPACT_INTERMEDIATE and precision == "default"
    inter = torch.bfloat16 if compact else None
    x_ts = prepared if prepared is not None else _ts_layout(x, mode)
    u_big = factors[big].permute(1, 0, 2).reshape(i_b, b * r)
    t = tier_matmul(x_ts, u_big, precision, inter)  # [I_n * prod(small), B*R]
    if not small:  # 2-D: the TTM is the whole MTTKRP
        return t.reshape(i_n, b, r).permute(1, 0, 2).to(x.dtype).contiguous()
    tb = t.reshape(i_n, *(x.shape[m] for m in small), b * r).movedim(-1, 0)  # [C, I_n, small...]
    while small:
        m = max(small, key=lambda mm: (x.shape[mm], mm))
        last = len(small) == 1
        u = factors[m].permute(1, 0, 2).reshape(x.shape[m], b * r)
        tb = _ttv(tb, u, 2 + small.index(m), precision, None if last else inter)
        small.remove(m)
    return tb.reshape(b, r, i_n).permute(0, 2, 1).to(x.dtype).contiguous()


def mttkrp_batched(x: torch.Tensor, factors, mode: int, method: str = "krp_gemm",
                   precision: str = "highest", prepared: torch.Tensor | None = None,
                   pred: torch.Tensor | None = None) -> torch.Tensor:
    """[B, I_mode, R] by ``method``, a mode the fused gate refuses taking
    the twostep. ``prepared`` is ``prepare_mode``'s layout of the mode
    (None: derived here); ``pred``, the fused kernels' launch predicate
    (``ops/fused_mttkrp.py``), is ignored by the other methods, which
    always compute. Where the gate sends an asked ``"pallas"`` to the
    twostep, ``prepared`` (the fused kernels' layout) is not the twostep's,
    and the twostep's is derived. A derived layout counts on ``LAYOUTS``."""
    b, r = factors[0].shape[0], factors[0].shape[-1]
    asked, method = method, resolve_batched_method(method, x.shape, mode, x.dtype, x.device, b, r)
    if method != asked or prepared is None:
        prepared = _derived(x, prepare_mode(x, mode, method, precision))
    if method == "pallas":
        ROUTES.add("fused")
        return mttkrp_batched_fused(x, factors, mode, prepared, precision, pred)
    if method in ("krp_gemm", "auto"):
        ROUTES.add("krp_gemm")
        return mttkrp_batched_krp(x, factors, mode, precision, prepared)
    ROUTES.add("twostep")
    return mttkrp_batched_twostep(x, factors, mode, precision, prepared)


# ------------------------------------------------------------ FLOP accounting


def mttkrp_flops(modes: Sequence[int], rank: int, mode: int, batch: int = 1) -> int:
    """FLOPs for the KRP-GEMM formulation of one batched MTTKRP."""
    p = int(np.prod([m for i, m in enumerate(modes) if i != mode]))
    return p * rank * batch + 2 * modes[mode] * p * rank * batch


def als_iteration_flops(modes: Sequence[int], rank: int, batch: int = 1) -> int:
    """FLOPs for one full ALS iteration (all-mode MTTKRPs + updates)."""
    total = 0
    for n in range(len(modes)):
        total += mttkrp_flops(modes, rank, n, batch)
        total += batch * (3 * modes[n] * rank * rank + rank**3 // 3)
    return total


# ------------------------------------------------- dimension tree (3-D only)


def dimtree_layout(x: torch.Tensor) -> torch.Tensor:
    """The shared TTM's tensor layout: [I1 * I2, I0]."""
    return x.permute(1, 2, 0).reshape(-1, x.shape[0])


def dimtree_ttm(x: torch.Tensor, f0: torch.Tensor, precision: str = "highest",
                prepared: torch.Tensor | None = None) -> torch.Tensor:
    """T = X x_0 A, one packed product: [I1, I2, B, R], from the just-updated
    mode-0 factor ``f0`` [B, I0, R]. T stays in the working dtype at every
    tier (no compact intermediate): it feeds both remaining modes, and a
    bf16 T would add a rounding stage to each (the JAX package measured
    3.2e-3 of mean fit at 50 iterations)."""
    b, i0, r = f0.shape
    xd = prepared if prepared is not None else _derived(x, dimtree_layout(x))
    t = tier_matmul(xd, f0.permute(1, 0, 2).reshape(i0, b * r), precision)
    return t.reshape(x.shape[1], x.shape[2], b, r)


def dimtree_ttv(t: torch.Tensor, factors, mode: int, precision: str = "highest") -> torch.Tensor:
    """G[mode] (1 or 2) from the shared TTM: the other remaining mode's
    factor contracted elementwise in (B, R), in the factor dtype."""
    other = 2 if mode == 1 else 1
    i1, i2, b, r = t.shape
    u = factors[other].permute(1, 0, 2).reshape(t.shape[other - 1], b * r)
    tb = t.reshape(i1, i2, b * r).movedim(-1, 0)  # [C, I1, I2]
    g = _ttv(tb, u, other, precision).to(factors[other].dtype)  # [C, I_mode]
    ROUTES.add("dimtree")
    return g.reshape(b, r, -1).permute(0, 2, 1).contiguous()
