"""Configuration structs of the PyTorch/CUDA port.

Field for field the same names and defaults as ``cp_cals_tpu/config.py``,
so a configuration carries over between the two packages unchanged
(``convert.params_from_dict``). The port runs unconstrained and NNLS
updates (``nnls_algorithm`` "bpp" or "lawson_hanson") on tensors of any
order >= 3, both line searches (``line_search_method``), the debug
monotonicity hook (``debug``), per-iteration and mixed-tier stopping
(``tol_check_interval``), polish sweeps (``polish_iters``, ``polish_tol``),
both engine loops (``sync_mode``), every MTTKRP method (fused, twostep,
krp_gemm; the dimension tree; held or recomputed layouts), the fused
epilogue, and the unfused epilogue with any of the three solves (``"gj"``,
``"chol"``, ``"pallas"``). ``check_supported`` raises ``ValueError`` for a
value the JAX package does not take either.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Optional

import torch

PRECISIONS = ("default", "high", "highest")
NNLS_ALGORITHMS = ("bpp", "lawson_hanson")


class UpdateMethod(enum.Enum):
    UNCONSTRAINED = "unconstrained"
    NNLS = "nnls"


class MttkrpMethod(enum.Enum):
    """``PALLAS`` keeps its name and value so a JAX configuration carries
    over 1:1; in the port it selects the hand-written fused CUDA MTTKRP
    (``ops/fused_mttkrp.py``)."""

    KRP_GEMM = "krp_gemm"
    TWOSTEP = "twostep"
    PALLAS = "pallas"
    AUTO = "auto"


class LineSearchMethod(enum.Enum):
    NO_ERROR_CHECKING = "no_error_checking"
    ERROR_CHECKING = "error_checking"


@dataclasses.dataclass(frozen=True)
class AlsParams:
    """Single-model ALS parameters (fields of cp_cals_tpu.config.AlsParams)."""

    max_iterations: int = 200
    tol: float = 1e-7
    update_method: UpdateMethod = UpdateMethod.UNCONSTRAINED
    mttkrp_method: MttkrpMethod = MttkrpMethod.AUTO
    line_search: bool = False
    line_search_interval: int = 5
    line_search_step: float = 0.0
    line_search_method: LineSearchMethod = LineSearchMethod.NO_ERROR_CHECKING
    force_max_iter: bool = False
    nnls_max_outer: int = 0
    nnls_algorithm: str = "bpp"
    precision: str = "highest"
    mttkrp_precision: Optional[str] = None
    tol_check_interval: int = 0
    solve_method: str = "gj"
    epilogue: str = "auto"
    mode_layouts: str = "auto"
    dimtree: str = "auto"
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class CalsParams:
    """Concurrent-ALS parameters (fields of cp_cals_tpu.config.CalsParams).

    ``buffer_size`` is the global padded-column budget split across rank
    buckets; ``bucket_threads`` host threads run the buckets of a wave,
    each bucket on a CUDA stream of its own (one on a mesh;
    ``solvers/cals.py``). Its default is 1, where the JAX package's is 4:
    on the H100 four threads ran the bench workload 1.65-1.92x slower
    than one (PERF.md), so threads are asked for, not assumed.
    """

    max_iterations: int = 200
    tol: float = 1e-7
    update_method: UpdateMethod = UpdateMethod.UNCONSTRAINED
    mttkrp_method: MttkrpMethod = MttkrpMethod.AUTO
    line_search: bool = False
    line_search_interval: int = 5
    line_search_step: float = 0.0
    line_search_method: LineSearchMethod = LineSearchMethod.NO_ERROR_CHECKING
    force_max_iter: bool = False
    always_evict_first: bool = False
    bucket_ranks: tuple[int, ...] = (4, 8, 16, 32)
    buffer_size: int = 4200
    nnls_max_outer: int = 0
    nnls_algorithm: str = "bpp"
    precision: str = "highest"
    mttkrp_precision: Optional[str] = None
    tol_check_interval: int = 0
    polish_iters: int = 0
    polish_tol: float = 0.0
    solve_method: str = "gj"
    epilogue: str = "auto"
    mode_layouts: str = "auto"
    sync_mode: str = "evict"
    evict_batch: int = 1
    bucket_threads: int = 1
    tail_compaction_depth: int = 2
    result_wire_dtype: Optional[str] = None
    dimtree: str = "auto"
    debug: bool = False


def check_supported(params: AlsParams | CalsParams) -> None:
    """Raise for every setting the port does not run."""
    if params.nnls_algorithm not in NNLS_ALGORITHMS:
        raise ValueError(f"nnls_algorithm={params.nnls_algorithm!r}: expected one of {NNLS_ALGORITHMS}")
    if params.dimtree not in ("auto", "on", "off"):
        raise ValueError(f"dimtree={params.dimtree!r}")
    if params.mode_layouts not in ("auto", "materialized", "recompute"):
        raise ValueError(f"mode_layouts={params.mode_layouts!r}")
    if params.solve_method not in ("gj", "chol", "pallas"):
        raise ValueError(f"solve_method={params.solve_method!r}")
    if params.epilogue not in ("auto", "fused", "xla"):
        raise ValueError(f"epilogue={params.epilogue!r}")
    for p in (params.precision, params.mttkrp_precision or params.precision):
        if p not in PRECISIONS:
            raise ValueError(f"precision {p!r}: expected one of {PRECISIONS}")
    if isinstance(params, CalsParams):
        if params.sync_mode not in ("evict", "iter"):
            raise ValueError(f"sync_mode={params.sync_mode!r}")
        if params.result_wire_dtype not in (None, "float16", "bfloat16"):
            raise ValueError(
                f"result_wire_dtype={params.result_wire_dtype!r}"
            )


def resolve_epilogue(params: AlsParams | CalsParams) -> str:
    """``"auto"`` resolves to the fused kernels with the Gauss-Jordan solve
    (an intended difference from the JAX package, whose ``"auto"`` is the
    unfused XLA path), and to the unfused path with any other solve: the
    fused kernels always invert by Gauss-Jordan, so they cannot honour
    ``"chol"`` or ``"pallas"``. An explicit ``"fused"`` with such a solve
    raises ``ValueError``."""
    if params.epilogue == "xla":
        return "xla"
    if params.solve_method == "gj":
        return "fused"
    if params.epilogue == "fused":
        raise ValueError(
            f"epilogue='fused' inverts by Gauss-Jordan and cannot honour "
            f"solve_method={params.solve_method!r}; use epilogue='auto' or 'xla'"
        )
    return "xla"


def resolve_mttkrp_method(params: AlsParams | CalsParams, shape, dtype, device) -> tuple[str, ...]:
    """The MTTKRP method of each mode of a tensor of ``shape`` where no
    bucket's methods are given (``cp_als``, ``cp_batched_als``, and a
    ``make_iteration`` called without ``mttkrp_methods``). ``AUTO`` takes
    ``utils/lut.py:heuristic_methods`` (the fused kernels where their
    static gate takes the mode, the twostep elsewhere) and never reads a
    table, as the JAX package's ALS does; the engine resolves AUTO per
    bucket from the table (``solvers/cals.py:_resolve_bucket_methods``).
    An explicit method is honoured; the batched dispatch still sends a
    mode the fused gate refuses to the twostep, as the JAX package does."""
    from .ops.mttkrp import resolve_batched_method
    from .utils.lut import heuristic_methods

    method = params.mttkrp_method.value
    if method == "auto":
        return heuristic_methods(tuple(shape), dtype=dtype, device=device)
    return tuple(resolve_batched_method(method, shape, n, dtype, device) for n in range(len(shape)))


def resolve_dimtree(params: AlsParams | CalsParams, ndim: int) -> bool:
    """Whether the sweep takes modes 1 and 2 from one shared TTM: ``"on"``
    on 3-D tensors, as in the JAX package. ``"auto"`` is off in the port:
    the JAX package's rule (on at the non-bf16 tiers) was measured on a TPU
    (ROADMAP section 3)."""
    return params.dimtree == "on" and ndim == 3


# The JAX package's rule, which "auto" keeps off a CUDA card.
LAYOUT_RECOMPUTE_BYTES = 128 * 1024 * 1024
# The share of a CUDA card's total memory that "auto" lets X's held layouts take.
LAYOUT_CARD_SHARE = 0.25


@functools.lru_cache(maxsize=None)
def card_memory(index: int) -> int:
    """The total memory of CUDA card ``index`` in bytes, read once."""
    return torch.cuda.get_device_properties(index).total_memory


def held_layout_bytes(params: AlsParams | CalsParams, shape, itemsize: int) -> int:
    """The most bytes ``mode_layouts="materialized"`` holds for a tensor of
    ``shape`` whose elements take ``itemsize`` bytes, whatever MTTKRP
    method a bucket picks: per mode the larger of the fused kernels' layout
    (3-D, ``ops/fused_mttkrp.held_nbytes``) and X's own bytes (the
    twostep's or krp_gemm's), at the MTTKRP's tier and, where the
    mixed-tier check or polish sweeps run, at ``params.precision`` too;
    plus the dimension tree's shared layout where it runs."""
    from .ops.fused_mttkrp import held_nbytes

    n_modes = len(shape)
    x_bytes = math.prod(shape) * itemsize
    tiers = {params.mttkrp_precision or params.precision}
    if params.tol_check_interval > 0 or getattr(params, "polish_iters", 0) > 0:
        tiers.add(params.precision)
    per_mode = [max(x_bytes, held_nbytes(shape, n, t, itemsize) if n_modes == 3 else 0)
                for t in tiers for n in range(n_modes)]
    return sum(per_mode) + (x_bytes if resolve_dimtree(params, n_modes) else 0)


def resolve_layouts(params: AlsParams | CalsParams, x, device=None) -> str:
    """``mode_layouts``: ``"auto"`` holds X's layouts where they fit the
    device's budget and derives them inside the iteration otherwise. On a
    CUDA card ``held_layout_bytes`` must fit ``LAYOUT_CARD_SHARE`` of the
    card's total memory; on any other device X must fit 128 MB, the JAX
    package's rule (``cp_cals_tpu/solvers/iteration.py:195-202``).
    ``device`` (default ``x.device``) lets a caller resolve on a meta
    tensor of X's shape. The budget reads total memory, not free memory,
    so that the policy, a part of the kept graphs' key
    (``solvers/cals.py``), does not change from call to call."""
    if params.mode_layouts != "auto":
        return params.mode_layouts
    dev = torch.device(device if device is not None else x.device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        budget = LAYOUT_CARD_SHARE * card_memory(index)
        fits = held_layout_bytes(params, tuple(x.shape), x.element_size()) <= budget
    else:
        fits = x.numel() * x.element_size() <= LAYOUT_RECOMPUTE_BYTES
    return "materialized" if fits else "recompute"
