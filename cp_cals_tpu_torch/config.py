"""Configuration structs of the PyTorch/CUDA port.

Field for field the same names and defaults as ``cp_cals_tpu/config.py``,
so a configuration carries over between the two packages unchanged
(``convert.params_from_dict``). The port runs unconstrained updates without
line search, per-iteration and mixed-tier stopping (``tol_check_interval``),
polish sweeps (``polish_iters``, ``polish_tol``), both engine loops
(``sync_mode``), the fused MTTKRP, the fused epilogue, and the unfused
epilogue with any of the three solves (``"gj"``, ``"chol"``, ``"pallas"``).
Other values of features not yet ported raise ``NotImplementedError``
naming their ROADMAP item (``check_supported``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

PRECISIONS = ("default", "high", "highest")


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
    buckets; ``bucket_threads`` is accepted and not used yet (buckets run
    one after another, ROADMAP queue 1 item 1).
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
    bucket_threads: int = 4
    tail_compaction_depth: int = 2
    result_wire_dtype: Optional[str] = None
    dimtree: str = "auto"
    debug: bool = False


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA package yet "
        f"(ROADMAP {item})"
    )


def check_supported(params: AlsParams | CalsParams) -> None:
    """Raise for every setting this slice of the port does not run."""
    if params.update_method != UpdateMethod.UNCONSTRAINED:
        raise not_ported("update_method=NNLS", "queue 1 item 6")
    if params.line_search:
        raise not_ported("line_search", "queue 1 item 6")
    if params.debug:
        raise not_ported("debug (monotonicity hook)", "queue 1 item 6")
    if params.mttkrp_method in (MttkrpMethod.KRP_GEMM, MttkrpMethod.TWOSTEP):
        raise not_ported(
            f"mttkrp_method={params.mttkrp_method.value}", "queue 1 item 5"
        )
    if params.dimtree not in ("auto", "off"):
        if params.dimtree == "on":
            raise not_ported("dimtree='on'", "queue 1 item 5")
        raise ValueError(f"dimtree={params.dimtree!r}")
    if params.mode_layouts not in ("auto", "materialized"):
        if params.mode_layouts == "recompute":
            raise not_ported("mode_layouts='recompute'", "queue 1 item 5")
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


def resolve_mttkrp_method(params: AlsParams | CalsParams, ndim: int) -> str:
    """``AUTO`` resolves to the fused kernel on 3-D tensors until the CUDA
    lookup table lands (ROADMAP queue 1 item 9)."""
    if ndim != 3:
        raise not_ported(f"a {ndim}-D tensor (twostep MTTKRP)", "queue 1 item 5")
    return "pallas"
