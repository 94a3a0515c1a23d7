"""Khatri-Rao (column-wise Kronecker) product (port of
``cp_cals_tpu/ops/khatri_rao.py``).

Convention: ``khatri_rao(A, B)[i*JB + j, r] = A[i, r] * B[j, r]``: A's rows
vary slowest, as a row-major flatten of the modes ordered [A-mode, B-mode].
"""

from __future__ import annotations

from functools import reduce
from typing import Sequence

import torch


def khatri_rao(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise KRP: [..., IA, R] x [..., JB, R] -> [..., IA*JB, R]."""
    out = a[..., :, None, :] * b[..., None, :, :]
    return out.reshape(*out.shape[:-3], a.shape[-2] * b.shape[-2], a.shape[-1])


def khatri_rao_chain(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """KRP of a list of factors, the first factor's rows varying slowest."""
    return reduce(khatri_rao, factors)
