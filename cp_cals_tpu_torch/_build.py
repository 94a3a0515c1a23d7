"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``. All sources are compiled together
(one ``nvcc`` process each, started at once) on first use, into
``build/cuda/<hash>/`` beside the package (``build/`` is git-ignored); the
hash covers the sources and the flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is. Nothing is built when the package is
imported: the CPU tests import every module and have no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = (
    "fused_mttkrp.cu", "fused_mttkrp_tc.cu", "fused_epilogue.cu", "spd_inverse.cu",
    "probe_copy.cu",
)  # gj_elim.cuh, mttkrp_common.cuh and smem_attr.cuh are included by these

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> dict[str, Path]:
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {s: out_dir / (Path(s).stem + ".so") for s in SOURCES}
    todo = [s for s, t in targets.items() if not t.exists()]
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for s in todo:
            tmp = targets[s].with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        errors = []
        for s, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {s} failed ({proc.returncode}):\n{log}")
            else:
                os.replace(tmp, targets[s])
        if errors:
            raise RuntimeError("\n".join(errors))
        BUILD_SECONDS["wall"] = time.perf_counter() - t0
    return targets


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building every kernel
    source on first use."""
    with _lock:
        if not _libs:
            for s, path in _build_all().items():
                _libs[s] = ctypes.CDLL(str(path))
        return _libs[source]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, read without
    building a ``torch.cuda.Stream`` object (``torch.cuda.current_stream``
    costs a few microseconds of every launch more;
    ``tools/probe_inverse_wrapper.py`` times both)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
