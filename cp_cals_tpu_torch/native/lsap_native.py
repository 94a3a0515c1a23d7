"""ctypes binding of the native LSAP solver (``lsap.cpp``; a copy of
``cp_cals_tpu/native/lsap_native.py``). The library is built on first use
and a failed build raises."""

from __future__ import annotations

import ctypes

import numpy as np

from . import load

_SIGNATURES = {
    "solve_lsap": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]),
}


def solve_lsap(cost: np.ndarray, maximize: bool = False) -> np.ndarray:
    """Return col4row: row i is assigned column col4row[i]; total cost is
    minimized (or maximized)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    nr, nc = cost.shape
    if nr > nc:
        # Solve the transpose and invert the assignment.
        c4r = solve_lsap(cost.T, maximize)
        inv = np.full(nr, -1, dtype=np.int64)
        for r, c in enumerate(c4r):
            inv[c] = r
        return inv
    out = np.empty(nr, dtype=np.int64)
    rc = load("lsap", _SIGNATURES).solve_lsap(
        nr,
        nc,
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(maximize),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise ValueError(f"lsap solve failed (rc={rc})")
    return out
