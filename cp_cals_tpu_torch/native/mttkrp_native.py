"""ctypes binding of the host C++/OpenMP MTTKRP (``mttkrp_ref.cpp``; a copy
of ``cp_cals_tpu/native/mttkrp_native.py``): the yardstick beside which the
card's MTTKRP routes are timed. The library is built with g++ (``-O3
-fopenmp``) on first use, and a failed build raises."""

from __future__ import annotations

import ctypes

import numpy as np

from . import load

_DP = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "mttkrp3_f64": (None, [_DP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           _DP, _DP, _DP, ctypes.c_int64, ctypes.c_int, _DP]),
}


def mttkrp3(x: np.ndarray, factors, mode: int) -> np.ndarray:
    """3-D MTTKRP in float64 of C-order arrays: X [I0, I1, I2], factors
    [I_m, R]. Returns [I_mode, R]."""
    if x.ndim != 3 or len(factors) != 3 or not 0 <= mode < 3:
        raise ValueError(f"mttkrp3 takes a 3-D tensor, three factors and a mode in 0..2 (got {x.ndim}-D, "
                         f"{len(factors)} factors, mode {mode})")
    x = np.ascontiguousarray(x, dtype=np.float64)
    fs = [np.ascontiguousarray(f, dtype=np.float64) for f in factors]
    r = fs[0].shape[1]
    if any(f.shape != (m, r) for f, m in zip(fs, x.shape)):
        raise ValueError(f"factor shapes {[f.shape for f in fs]} do not match X {x.shape} at rank {r}")
    out = np.zeros((x.shape[mode], r), dtype=np.float64)
    load("mttkrp_ref", _SIGNATURES).mttkrp3_f64(
        x.ctypes.data_as(_DP), x.shape[0], x.shape[1], x.shape[2],
        fs[0].ctypes.data_as(_DP), fs[1].ctypes.data_as(_DP), fs[2].ctypes.data_as(_DP),
        r, mode, out.ctypes.data_as(_DP),
    )
    return out
