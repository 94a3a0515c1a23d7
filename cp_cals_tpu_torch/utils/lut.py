"""MTTKRP method lookup tables and their autotune (port of
``cp_cals_tpu/utils/lut.py``).

Per (tensor shape, bucket rank, batch, precision tier) and per mode, each
MTTKRP method is measured on the card and the winner stored; the engine's
``mttkrp_method=AUTO`` reads the winners per bucket
(``solvers/cals.py:_resolve_bucket_methods``).

Tables are JSON files under ``cp_cals_tpu_torch/lookup_tables/<device>/
<d0-d1-...>.json`` mapping ``"BxR[@tier]:mode" -> method``, the JAX
package's format; the JAX tables under ``data/lookup_tables/`` are neither
read nor written. The device tag is ``cuda-<card name>`` with spaces as
underscores (``cuda-NVIDIA_H100_80GB_HBM3``), and ``cpu-cpu`` on the CPU,
where no table is shipped, so lookups there fall to the heuristic.

The methods are the port's ``MttkrpMethod`` values: ``"krp_gemm"``,
``"twostep"`` and ``"pallas"``, the hand-written fused CUDA kernels
(``ops/fused_mttkrp.py``). Tiers: an unsuffixed key is "high" (the hi/lo
bf16 tensor-core kernel and three bf16 GEMMs), ``@default`` one bf16 pass,
and ``@highest`` strict fp32 (the CUDA-core kernel and fp32 GEMMs). JAX
keys "highest" as "high", since on the TPU both run multi-pass bf16; on the
card they run different code.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import torch

from ..launches import Tally

_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "lookup_tables")

METHODS = ("krp_gemm", "twostep", "pallas")

# Where the last per-mode method decisions came from (reset with
# reset_lookup_stats): an exact table entry, the nearest-B*R entry of the
# same table, or the heuristic (a Tally: exact under threads).
LOOKUP_STATS = Tally(fixed=("exact", "nearest", "heuristic"))

_TUNE_LOCK = threading.Lock()


def reset_lookup_stats() -> None:
    LOOKUP_STATS.clear()


def _tier(precision: str | None) -> str:
    """A matmul precision's table tier: "high" for None too (the JAX
    package's default), else the precision itself."""
    return "high" if precision in (None, "", "high") else precision


def _key(batch: int, rank: int, mode: int, precision: str = "high") -> str:
    """Table key: ``BxR:mode`` at "high", ``BxR@tier:mode`` at the others."""
    core = f"{batch}x{rank}"
    tier = _tier(precision)
    if tier != "high":
        core += f"@{tier}"
    return f"{core}:{mode}"


def _device(device=None) -> torch.device:
    from ..device import resolve_device

    return resolve_device(device)


def _device_tag(device=None) -> str:
    dev = _device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return f"{dev.type}-{name}".replace(" ", "_")


def _table_path(modes, device=None) -> str:
    shape = "-".join(str(m) for m in modes)
    return os.path.join(_ROOT, _device_tag(device), f"{shape}.json")


def _load(modes, device=None) -> dict:
    path = _table_path(modes, device)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _store(modes, table: dict, device=None) -> None:
    """Written to a file of its own and moved into place, so a reader never
    sees half a table."""
    path = _table_path(modes, device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def heuristic_methods(modes, rank: int = 0, batch: int = 0, precision: str = "high",
                      dtype=torch.float32, device="cpu") -> tuple[str, ...]:
    """The method of each mode where no table entry exists: the fused
    kernels where their static gate takes the mode, else the twostep
    (every mode of an N-D tensor, and float64 on the card). Measured on
    the H100 (PERF.md §6, PR 7): the fused kernel 0.1394 ms against the
    twostep's 0.1938 replayed at "highest", 0.0322 against 0.1439 at
    "default". The JAX package's TPU grounds (the twostep at the v5e
    roofline, a 256 MB intermediate boundary) are not carried over.
    ``precision`` is accepted for the JAX signature; the rule does not
    depend on it."""
    return tuple(_screen("pallas", modes, n, rank, batch, dtype, device) for n in range(len(modes)))


def _screen(method: str, modes, mode: int, rank: int, batch: int, dtype=torch.float32, device="cpu") -> str:
    """Send a ``"pallas"`` pick the fused kernels' static gate refuses at
    this (batch, rank), dtype and device to the twostep: reachable from a
    nearest entry measured at a smaller (batch, rank), or from a table
    measured in another dtype."""
    if method == "pallas":
        from ..ops.fused_mttkrp import fused_mttkrp_supported

        if not fused_mttkrp_supported(tuple(modes), mode, max(batch, 1), max(rank, 1), dtype, device):
            return "twostep"
    return method


def _nearest(table: dict, batch: int, rank: int, mode: int, precision: str = "high") -> str | None:
    """The method of the measured entry of this mode nearest in
    |log(B*R ratio)|; entries at the requested tier first, other tiers only
    where the requested tier has none."""
    target = batch * rank
    best = None  # (tier_penalty, distance, method)
    for key, method in table.items():
        if method not in METHODS:
            continue
        core, _, mode_s = key.partition(":")
        if mode_s != str(mode):
            continue
        if "@" in core:
            core, _, prec = core.partition("@")
        else:
            prec = "high"
        try:
            b_s, _, r_s = core.partition("x")
            br = int(b_s) * int(r_s)
        except ValueError:
            continue
        cand = (0 if prec == _tier(precision) else 1, abs(math.log(max(br, 1) / max(target, 1))), method)
        if best is None or cand[:2] < best[:2]:
            best = cand
    return best[2] if best else None


def lookup_methods(modes, rank: int, batch: int, precision: str = "high", dtype=torch.float32,
                   device=None) -> tuple[str, ...]:
    """Each mode's method from the device's table: its exact entry, else the
    nearest entry, else the heuristic; every pick screened by the fused
    gate at (batch, rank), ``dtype`` and ``device``. Counts each decision
    in ``LOOKUP_STATS``."""
    dev = _device(device)
    table = _load(modes, dev)
    out = []
    for mode in range(len(modes)):
        m = table.get(_key(batch, rank, mode, precision))
        if m in METHODS:
            LOOKUP_STATS.add("exact")
            out.append(_screen(m, modes, mode, rank, batch, dtype, dev))
            continue
        m = _nearest(table, batch, rank, mode, precision)
        if m is not None:
            LOOKUP_STATS.add("nearest")
            out.append(_screen(m, modes, mode, rank, batch, dtype, dev))
            continue
        LOOKUP_STATS.add("heuristic")
        out.append(heuristic_methods(modes, rank, batch, precision, dtype, dev)[mode])
    return tuple(out)


def has_exact_entries(modes, rank: int, batch: int, precision: str = "high", device=None) -> bool:
    table = _load(modes, device)
    return all(table.get(_key(batch, rank, mode, precision)) in METHODS for mode in range(len(modes)))


def ensure_methods(modes, rank: int, batch: int, dtype=torch.float32, precision: str = "high", reps: int = 3,
                   device=None) -> tuple[str, ...]:
    """``lookup_methods``, after autotuning and storing the entries of this
    (batch, rank, tier) where any is missing. Thread-safe: concurrent
    autotunes of one shape would time against each other and race the
    table's write."""
    dev = _device(device)
    if not has_exact_entries(modes, rank, batch, precision, dev):
        with _TUNE_LOCK:
            if not has_exact_entries(modes, rank, batch, precision, dev):
                autotune(modes, rank, batch, dtype=dtype, reps=reps, precision=precision, device=dev)
    return lookup_methods(modes, rank, batch, precision, dtype, dev)


N_LOOP = 20  # batched MTTKRPs per timed replay


def _time_candidates(fns: dict, reps: int, device: torch.device) -> dict:
    """ms per call of each candidate (a function of no arguments), the least
    over ``reps`` rounds, the candidates in turns within each round (A, B,
    C, A, B, C, ...). On the card each candidate is ``N_LOOP`` calls
    captured into one CUDA graph (after one eager call on a side stream,
    which builds and plans its kernels) and replayed between two CUDA
    events; on the CPU the calls run eagerly, timed by the host's clock."""
    times = {m: float("inf") for m in fns}
    if device.type != "cuda":
        for fn in fns.values():
            fn()
        for _ in range(reps):
            for m, fn in fns.items():
                t0 = time.perf_counter()
                for _ in range(N_LOOP):
                    fn()
                times[m] = min(times[m], (time.perf_counter() - t0) * 1e3 / N_LOOP)
        return times
    side = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    pool = torch.cuda.graph_pool_handle()
    graphs = {}
    for m, fn in fns.items():
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=side):
                for _ in range(N_LOOP):
                    fn()
        cur.wait_stream(side)
        graphs[m] = g
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize(device)
    for _ in range(reps):
        for m, g in graphs.items():
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times[m] = min(times[m], start.elapsed_time(end) / N_LOOP)
    return times


LAST_TIMES: dict = {}  # "BxR[@tier]:mode" -> {method: ms per call} of the last autotunes


def autotune(modes, rank: int, batch: int, dtype=torch.float32, reps: int = 3, precision: str = "high",
             margin: float = 0.10, device=None) -> tuple[str, ...]:
    """Time every method the static gate takes, per mode, on X and factors
    drawn from a ``torch.Generator`` of seed 0 on ``device``
    (``_time_candidates``: each candidate's held layout prepared once,
    outside the timing; the least of ``reps``), and store the winners.
    The twostep keeps a mode unless another method beats it by more than
    ``margin``. Only what the gate refuses is skipped: a kernel that fails
    to build or launch raises. Launches made here leave no trace in the
    launch and route counts (``launches.py``). The times land in
    ``LAST_TIMES``."""
    from .. import launches
    from ..ops.mttkrp import mttkrp_batched, prepare_mode, resolve_batched_method

    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(tuple(modes), generator=gen, device=dev, dtype=dtype)
    factors = [torch.randn((batch, m, rank), generator=gen, device=dev, dtype=dtype) for m in modes]
    table = _load(modes, dev)
    winners = []
    before = launches.snapshot()
    try:
        for mode in range(len(modes)):
            fns = {}
            for method in METHODS:
                if resolve_batched_method(method, modes, mode, dtype, dev, batch, rank) != method:
                    continue
                held = prepare_mode(x, mode, method, precision)
                fns[method] = (lambda method=method, held=held:
                               mttkrp_batched(x, factors, mode, method, precision, held))
            times = _time_candidates(fns, reps, dev)
            best = min(times, key=times.get)
            if best != "twostep" and "twostep" in times and times["twostep"] <= times[best] * (1.0 + margin):
                best = "twostep"
            winners.append(best)
            key = _key(batch, rank, mode, precision)
            table[key] = best
            LAST_TIMES[key] = times
            del fns
    finally:
        launches.take_added(before)
    _store(modes, table, dev)
    return tuple(winners)
