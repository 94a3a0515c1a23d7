"""Launch-overhead probe of the card (counterpart of ``scripts/probe_overhead.py``).

    python -m cp_cals_tpu_torch.probe_overhead

Times N = 50 dependent steps of each body below, on the JAX script's shapes
(``[96, 20, 20]`` and ``[96, 301, 20]`` float32), twice: launched eagerly
from the host step after step, and captured once in a CUDA graph and
replayed (the counterpart of the JAX script's single compiled
``fori_loop``). A time is the best of four runs of the N-step loop, each
ending in one fetch of a scalar to the host, less the null round trip (a
reduction of a small tensor fetched to the host), over N, as the JAX script
computes it.

If every small body costs the same whatever its content, small-kernel times
measure the launch floor, and the target is the number of launches, not
FLOPs or bytes.

Bodies: one tiny elementwise op; 16 dependent tiny ops; 8 small batched
matmuls; one launch of the hand-written copy kernel (``csrc/probe_copy.cu``,
``o = x * 0.999``), small and big; one big elementwise op; a reduction and
an elementwise op. The result goes to ``chiprun_out/overhead_probe.json``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import time
from pathlib import Path

import torch

from . import _build, launches
from .device import resolve_device

N = 50
SMALL = (96, 20, 20)
BIG = (96, 301, 20)
OUT = Path(__file__).resolve().parent.parent / "chiprun_out" / "overhead_probe.json"


def probe_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 0.999


@functools.cache
def _lib():
    lib = _build.load("probe_copy.cu")
    if lib.probe_copy_launch.argtypes is None:
        lib.probe_copy_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
        )
        lib.probe_copy_launch.restype = ctypes.c_int
    return lib


@launches.wrapper()
def probe_copy(x: torch.Tensor) -> torch.Tensor:
    """``x * 0.999`` for a float32 tensor: the plain version on the CPU, the
    copy kernel on the card."""
    dev = x.device
    if dev.type == "cpu":
        return probe_copy_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"probe_copy: unsupported device {dev}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"probe_copy: contiguous float32 only, got {x.dtype}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    code = _lib().probe_copy_launch(x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_ptr(dev))
    _build.check(code, "probe_copy")
    probe_copy.count()
    return out


def _bodies(dev):
    small = torch.ones(SMALL, device=dev)
    big = torch.ones(BIG, device=dev)
    hb = (torch.eye(SMALL[-1], device=dev) * 1.0001).expand(SMALL).contiguous()

    def tiny(a):
        return a * 0.999 + 1e-9

    def sixteen(a):
        for _ in range(8):
            a = a * 0.999 + 1e-9
            a = torch.where(a > 2.0, a - 1.0, a)
        return a

    def matmuls(a):
        for _ in range(8):
            a = torch.bmm(a, hb)
        return a

    def reduce_elemwise(a):
        s = torch.sum(a, dim=1, keepdim=True)
        return a * 0.999 + s * 1e-9

    return [
        ("one_tiny_op", tiny, small),
        ("sixteen_tiny_ops", sixteen, small),
        ("eight_small_matmuls", matmuls, small),
        ("one_copy_kernel_small", probe_copy, small),
        ("one_copy_kernel_big", probe_copy, big),
        ("one_big_elemwise", tiny, big),
        ("reduce_plus_elemwise", reduce_elemwise, big),
    ]


def _fetch(a: torch.Tensor) -> float:
    return float((torch.sum(a) * 1e-20).item())


def _best(fn, reps: int = 4) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def null_roundtrip_ms(dev) -> float:
    """The null round trip on the card: the best of five fetches to the host
    of a reduction of an [8, 128] tensor, in ms."""
    z = torch.zeros((8, 128), device=dev)
    return _best(lambda: _fetch(z), reps=5) * 1e3


def _loop(body, a):
    for _ in range(N):
        a = body(a)
    return a


def _graph_replay(body, a0):
    """The N-step loop captured once in a CUDA graph; returns a function
    that replays it and fetches the result."""
    static = a0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        _loop(body, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _loop(body, static)

    def replay():
        graph.replay()
        return _fetch(out)

    return replay


def run_probe(device=None) -> dict:
    """Per-step times in ms of every body, eager and graph-captured, and
    the null round trip. Needs the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the overhead probe measures the card; it has no CPU mode")
    null = null_roundtrip_ms(dev) / 1e3
    res = {"device": torch.cuda.get_device_name(dev), "n_steps": N, "null_ms": null * 1e3}

    def per_step(fn) -> float:
        best = _best(fn)
        return max(best - null, best / 10) / N * 1e3

    for name, body, a in _bodies(dev):
        res[f"{name}_eager_ms"] = per_step(lambda: _fetch(_loop(body, a)))
        res[f"{name}_graph_ms"] = per_step(_graph_replay(body, a))
    return res


def report(res: dict) -> None:
    """Print the per-step times and write them, with the card's name and
    power limit, to ``OUT``."""
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"probe on {res['card']}: null round trip {res['null_ms']:.4f} ms", flush=True)
    for key, val in res.items():
        if key.endswith("_eager_ms"):
            name = key[: -len("_eager_ms")]
            print(f"probe {name:24s} eager {val:8.4f} ms/step, graph {res[name + '_graph_ms']:8.4f} ms/step",
                  flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))


def main() -> int:
    report(run_probe())
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
