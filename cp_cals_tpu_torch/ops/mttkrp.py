"""MTTKRP dispatch and FLOP accounting (port of
``cp_cals_tpu/ops/mttkrp.py:138-163, 303-345``).

In this slice the fused kernel (method ``"pallas"``, kept under the JAX
package's name) is the only method; ``krp_gemm`` and ``twostep`` raise
``NotImplementedError`` (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .fused_mttkrp import mttkrp_batched_fused, prepare_mode_tensor


def _resolve(method: str, x_ndim: int) -> str:
    if method not in ("pallas", "auto"):
        raise NotImplementedError(
            f"mttkrp method {method!r} is not ported yet (ROADMAP queue 1 item 5)"
        )
    if x_ndim != 3:
        raise NotImplementedError(
            f"the fused MTTKRP is 3-D; a {x_ndim}-D tensor needs the twostep "
            "(ROADMAP queue 1 item 5)"
        )
    return "pallas"


def prepare_batched(
    x: torch.Tensor, methods: Sequence[str], precision: str = "highest"
) -> tuple:
    """Loop-invariant per-mode tensor layouts, held for the MTTKRP tier
    ``precision`` (X, or its bf16 rounding or hi/lo split: one or two
    |X|-sized copies each)."""
    for m in methods:
        _resolve(m, x.ndim)
    return tuple(prepare_mode_tensor(x, n, precision) for n in range(x.ndim))


def mttkrp_batched(
    x: torch.Tensor, factors, mode: int, method: str = "pallas",
    precision: str = "highest", prepared: torch.Tensor | None = None,
    pred: torch.Tensor | None = None,
) -> torch.Tensor:
    """``pred``: the kernels' launch predicate (``ops/fused_mttkrp.py``)."""
    _resolve(method, x.ndim)
    return mttkrp_batched_fused(x, factors, mode, prepared, precision, pred)


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
