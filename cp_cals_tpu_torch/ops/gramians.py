"""Gramian and Hadamard-product ops (port of ``cp_cals_tpu/ops/gramians.py``).

Factors may carry leading batch dims ([B, I, R]); gramians are then
[B, R, R]. Float32 products run in strict float32 (TF32 off, ``device.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def gramian(factor: torch.Tensor) -> torch.Tensor:
    """G = U^T U, batched over leading dims."""
    return torch.matmul(factor.transpose(-1, -2), factor)


def gramians(factors: Sequence[torch.Tensor], tp=None) -> tuple:
    """Every factor's gramian; with ``tp`` (a ``parallel.sharding.TpRows``)
    factor 0's rows are split over ranks and its gramian summed over them."""
    return tuple(tp.sum(gramian(f)) if tp is not None and n == 0 else gramian(f) for n, f in enumerate(factors))


def hadamard_but_one(grams: Sequence[torch.Tensor], skip: int) -> torch.Tensor:
    """Elementwise product of all gramians except ``skip``: the normal
    matrix of the mode-``skip`` update."""
    out = None
    for n, g in enumerate(grams):
        if n == skip:
            continue
        out = g if out is None else out * g
    if out is None:
        raise ValueError("hadamard_but_one needs at least two gramians")
    return out


def hadamard_all(grams: Sequence[torch.Tensor]) -> torch.Tensor:
    out = grams[0]
    for g in grams[1:]:
        out = out * g
    return out
