"""Tensor files (port of ``cp_cals_tpu/tensor_io.py``).

The reference's text format: the first line holds the mode sizes, then one
value per line in column-major order (first mode fastest). Arrays here are
row-major, so values are transposed on the way in and out; the file is the
same. ``.npy`` and ``.npz`` files load directly.

Text files go through the native parser and writer (``native/tensorio.cpp``,
built with g++ at first use; a failed build raises): a Python loop is about
50x slower on 100^3 tensors and up. ``read_tensor_py`` and
``write_tensor_py`` are their plain NumPy versions.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_I64P, _F64P = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "tensor_file_modes": (ctypes.c_int, [ctypes.c_char_p, _I64P, ctypes.c_int]),
    "tensor_file_read": (ctypes.c_int64, [ctypes.c_char_p, _F64P, ctypes.c_int64]),
    "tensor_file_write": (ctypes.c_int, [ctypes.c_char_p, _I64P, ctypes.c_int, _F64P, ctypes.c_int64]),
}


def _lib() -> ctypes.CDLL:
    from .native import load

    return load("tensorio", _SIGNATURES)


def _load_numpy(path: str) -> np.ndarray | None:
    if path.endswith(".npy"):
        return np.asarray(np.load(path), dtype=np.float64)
    if path.endswith(".npz"):
        with np.load(path) as z:
            key = "x" if "x" in z.files else z.files[0]
            return np.asarray(z[key], dtype=np.float64)
    return None


def read_tensor(path: str) -> np.ndarray:
    """A row-major float64 array of the file's shape: the reference text
    format, or ``.npy`` / ``.npz`` (a single array, or one named 'x')."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    x = _load_numpy(path)
    if x is not None:
        return x
    lib = _lib()
    modes = np.zeros(16, dtype=np.int64)
    n = lib.tensor_file_modes(path.encode(), modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 16)
    if n <= 0:
        raise IOError(f"bad tensor file header: {path}")
    shape = tuple(int(m) for m in modes[:n])
    total = int(np.prod(shape))
    flat = np.empty(total, dtype=np.float64)
    got = lib.tensor_file_read(path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), total)
    if got != total:
        raise IOError(f"tensor file truncated: {path} ({got}/{total})")
    return flat.reshape(shape, order="F")  # column-major on disk


def write_tensor(path: str, x) -> None:
    """``x`` (NumPy or torch) in the reference text format, float64 with 17
    significant digits."""
    x = _as_float64(x)
    flat = np.ascontiguousarray(x.ravel(order="F"))
    modes = np.asarray(x.shape, dtype=np.int64)
    rc = _lib().tensor_file_write(
        path.encode(), modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(x.shape),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), flat.size,
    )
    if rc != 0:
        raise IOError(f"tensor write failed: {path}")


def _as_float64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def read_tensor_py(path: str) -> np.ndarray:
    """The plain NumPy reader of the text format (and ``.npy``/``.npz``)."""
    x = _load_numpy(path)
    if x is not None:
        return x
    with open(path) as f:
        shape = tuple(int(t) for t in f.readline().split())
        flat = np.loadtxt(f, dtype=np.float64, ndmin=1)
    if flat.size != int(np.prod(shape)):
        raise IOError(f"tensor file truncated: {path}")
    return flat.reshape(shape, order="F")


def write_tensor_py(path: str, x) -> None:
    """The plain NumPy writer of the text format."""
    x = _as_float64(x)
    with open(path, "w") as f:
        f.write(" ".join(str(m) for m in x.shape) + "\n")
        for v in x.ravel(order="F"):
            f.write(f"{v:.17g}\n")
