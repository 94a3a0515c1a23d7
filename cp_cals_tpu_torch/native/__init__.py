"""Build and load the port's host C++ libraries (``native/*.cpp``): the
tensor-file reader and writer (``tensorio.cpp``), the LSAP solver
(``lsap.cpp``) and the OpenMP MTTKRP yardstick (``mttkrp_ref.cpp``), copies
of the JAX package's.

Each source is compiled with ``g++`` at first use into
``build/native/<hash>/lib<name>.so`` beside the package (``build/`` is
git-ignored), with ``CXX_FLAGS`` and the library's own ``EXTRA_FLAGS``;
the hash covers the source and its flags. The JAX package builds the
MTTKRP with ``-march=native`` as well; here it is left out, so that a
build never depends on the host that made it. Processes that
build at once (test workers) each compile into a file of their own and
``os.replace`` it into place, so a library that exists is whole and is
loaded as it is. A failed build raises: there is no quiet fallback (the
NumPy versions are the plain references the tests hold these against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_ROOT = SRC.parent.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")
EXTRA_FLAGS = {"mttkrp_ref": ("-O3", "-fopenmp")}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def flags(name: str) -> tuple[str, ...]:
    return CXX_FLAGS + EXTRA_FLAGS.get(name, ())


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    h.update((SRC / f"{name}.cpp").read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest(name) / f"lib{name}.so"


def load(name: str, signatures: dict | None = None) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built on first use;
    ``signatures`` maps each function to its (restype, argtypes), set once
    when the library is loaded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = SRC / f"{name}.cpp"
        so = library_path(name)
        if not so.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"g++ not found: the native library {name} cannot be built")
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.tmp{os.getpid()}.{threading.get_ident()}")
            proc = subprocess.run([cxx, *flags(name), "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ {src.name} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in (signatures or {}).items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib
