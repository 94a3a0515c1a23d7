"""Concurrent ALS (CALS) engine: many CP models of varying rank fitted in
one stream (port of ``cp_cals_tpu/solvers/cals.py``).

Models are padded to a rank bucket and packed into batched slots
``[B, I_n, R]``; one global padded-column budget (``buffer_size``) is split
across buckets (``allocate_bucket_batches``). Each bucket runs lock-step
ALS iterations until at least one live model converges, then the host
evicts converged models (their eviction stats, and one packed gather of
their true-rank columns and lam), refills the vacated slots from the queue
by a masked select, and repeats. Padded columns and vacant slots are inert,
so concurrency is invisible to each model's trajectory.

The buckets of a wave run in ``bucket_threads`` host threads (the JAX
engine's design, ``cp_cals_tpu/solvers/cals.py:cp_cals``), the widest
bucket first, each bucket on a CUDA stream of its own with its own graph
memory pool and pinned buffers (its thread's, which the buckets a thread
runs one after another share), so that one bucket's host work (stats
fetches, evictions, refills, captures) runs while another's iterations run
on the card. Python holds the GIL, so host work overlaps device work, not
other host work. Buckets share no state on the device: a threaded run's
results are the serial run's bit for bit, and its launch counts
(``launches.py``, per thread) the same. On a mesh the buckets run one after
another (the SPMD host loop's collectives keep program order). The default
is one thread (the JAX package's is 4): on the H100 the bench workload is
bound by host Python, and four threads ran it 1.65-1.92x slower than one
(PERF.md).

Each eviction round fetches its stats, lam and factors in one fetch and
stores its models at once. The JAX engine defers the factors' fetch to a
pool of 4 threads and times their collection after the last bucket
(``CalsReport.materialize_s``); on the H100 a deferred round was no faster
(one sync a round either way, for a payload of a few KB; PERF.md),
so ``materialize_s`` reads 0 here.

The bucket loop is ``graph_loop.ChunkLoop`` by default (``sync_mode=
"evict"``): the run-until-evict loop in chunks of iterations, each chunk
replays of a CUDA graph on the card, one stats fetch per chunk, and the
polish sweeps at the end of each run-until-evict. ``sync_mode="iter"`` (and
``always_evict_first``) runs ``graph_loop.IterLoop``, one eager iteration
per host round, the JAX package's per-iteration mode and the eager
reference on the card. Refills upload through pinned memory without
blocking. A ``debug`` run takes the chunk loop eagerly, one iteration per
chunk, with no CUDA graph: its hook reads every iteration on the host.

A queue holds explicit Ktensors or ``RandomKtensorSpec``s, whose factors
are generated on the device (``ktensor.spec_block``: the JAX package's
threefry draws, bit for bit ``spec_to_ktensor`` of the spec in any bucket)
a window of the bucket's queue ahead of intake (``SpecAhead``), so that a
refill takes rows already built; explicit and spec models mix in one
block.

``trace`` takes one ``IterationRecord`` per engine iteration: from the
host in ``sync_mode="iter"`` (as JAX does), from a device buffer read with
each chunk's stats fetch in the chunk loop (``graph_loop``), where a
tol-driven chunk's iterations past the last live model's stop are
recorded too (they ran); records of threaded buckets interleave, each
with its bucket. ``checkpoint_dir`` snapshots each bucket (its
``SolverState``, slot metadata and finished models, the JAX engine's files
and keys) after every eviction round, after the round's refill, kill and
tail compaction; ``resume`` rebuilds a bucket's loop from its snapshot,
which captures its graphs anew.

Under ``mttkrp_method=AUTO`` every bucket takes its MTTKRP methods per
mode from the lookup table at its (rank, allocated batch), for its fast
tier and, where they differ, for its polish tier
(``_resolve_bucket_methods``); on the card a missing entry is autotuned and
stored first, every bucket's before any bucket runs (serially, before any
thread starts), so no autotune times against a running bucket. The held X
layouts are one per (mode, method,
tier) that some bucket needs, shared by the buckets that agree, and kept
until the call returns, since the captured graphs read them: at most one
per method and mode, and the fused kernels' at a second tier where the
check or the polish runs at another precision, each about |X| (at 500^3 in
float32, 500 MB a layout, up to 6 GB for 3 modes).

On a mesh (``mesh``, ``parallel/sharding.py``; one process per device)
every rank runs this function with the same arguments. dp gives each rank
its share of every bucket's slots (a bucket whose batch dp does not divide
is replicated); under ``shard_mode0`` tp gives it its rows of mode 0, of X
and of every factor 0, and the iteration sums over the tp group
(``solvers/iteration.py``). The host loop is SPMD: after each chunk one
host all-reduce gathers every rank's stats, so every rank takes the same
evictions, refills (each building only its own slots' rows: a spec's draws
are per model), kills and tail compactions, and the report equals a
single process's. Evicted results are gathered the same way, so every
rank returns the whole result list in queue order. A dp bucket's chunks
stay captured (no collective inside an iteration); a tp bucket's run
uncaptured (``captures`` 0), since the tp sums are collectives. The
checkpoint gathers each bucket's state and the coordinator alone writes;
resume loads it on every rank, each keeping its own slots and rows. Under
``mttkrp_method=AUTO`` a mesh run reads the table at the rank's block and
batch and never autotunes (ranks would time against each other and write
one table at once).

``precompile_buckets`` warms, ahead of a timed call, what a first call
pays for (the JAX package's name and arguments; PyTorch compiles nothing).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import os
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build, launches
from ..config import CalsParams, UpdateMethod, check_supported
from ..device import resolve_device
from ..ktensor import Ktensor, RandomKtensorSpec, scale_jk_rows, spec_block
from ..ops.mttkrp import als_iteration_flops
from ..parallel.distributed import is_coordinator
from ..parallel.sharding import Shard, tp_rows
from ..utils.checkpoint import load_state, save_state
from ..utils.timers import IterationRecord
from .graph_loop import NP_DTYPES, ChunkLoop, Graphs, IterLoop, Pinned, pack_evict_stats
from .iteration import make_iteration
from .state import SolverState, init_state, tree_where


@dataclass
class CalsModelReport:
    id: int
    rank: int
    iters: int
    fit: float
    approx_error: float


@dataclass
class CalsReport:
    n_ktensors: int = 0
    ktensor_comp_sum: int = 0
    # bucket rank -> engine iterations the bucket ran (every iteration of
    # the loop, frozen models' included, so kernel launches per mode equal
    # the sum of these plus the polish sweeps).
    engine_iterations: dict = field(default_factory=dict)
    models: list = field(default_factory=list)
    phase_times: dict = field(default_factory=dict)
    # The JAX engine's seconds collecting deferred results; 0 here, where
    # every eviction round fetches at once (module docstring).
    materialize_s: float = 0.0
    # bucket rank -> the loop's counts: graph captures and replays, stats
    # fetches (one per chunk, per polish check, per eviction round), polish
    # sweeps, and checkpoints written (one per eviction round under
    # checkpoint_dir).
    loop_counts: dict = field(default_factory=dict)


# ------------------------------------------------------- MTTKRP dispatch


def _resolve_bucket_methods(
    x_shape: tuple, r: int, b: int, params: CalsParams, dtype=torch.float32, device="cpu", autotune: bool = True
) -> tuple[tuple | None, tuple | None]:
    """Per-mode MTTKRP methods of a bucket of rank ``r`` and batch ``b``
    (``cp_cals_tpu/solvers/cals.py:_resolve_bucket_methods``): the fast
    tier's (``mttkrp_precision or precision``) for the main sweeps, and
    ``precision``'s for the polish sweeps, or None where they equal the
    fast tier's. (None, None) unless ``mttkrp_method`` is AUTO.

    The table is keyed by tier because the ranking of the methods changes
    with it. On the card a missing exact entry is autotuned and stored
    first (``utils/lut.ensure_methods``), unless ``CP_CALS_NO_AUTOTUNE`` is
    set, or ``autotune`` is False (a mesh run); on the CPU the table (or
    the heuristic) is read and nothing is timed. A float64 run reads and
    never autotunes: the table is keyed by tier, not dtype, so a float64
    measurement would stand for the float32 runs of that shape."""
    if params.mttkrp_method.value != "auto":
        return None, None
    from ..utils.lut import ensure_methods, lookup_methods

    dev = torch.device(device)
    tune = (autotune and dev.type == "cuda" and dtype == torch.float32
            and not os.environ.get("CP_CALS_NO_AUTOTUNE"))
    get = ensure_methods if tune else lookup_methods
    fast_tier = params.mttkrp_precision or params.precision
    methods = get(tuple(x_shape), r, b, precision=fast_tier, dtype=dtype, device=dev)
    polish_methods = None
    if params.polish_iters and params.mttkrp_precision:
        polish_methods = get(tuple(x_shape), r, b, precision=params.precision, dtype=dtype, device=dev)
        if polish_methods == methods:
            polish_methods = None
    return methods, polish_methods


# ------------------------------------------------------- bucketing and budget


def bucket_rank(rank: int, bucket_ranks: Sequence[int]) -> int:
    """Smallest configured bucket that fits ``rank``; next power of two above
    the largest configured bucket otherwise."""
    for b in sorted(bucket_ranks):
        if rank <= b:
            return b
    b = max(bucket_ranks)
    while b < rank:
        b *= 2
    return b


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _round_batch(n: int) -> int:
    """Quantize a bucket batch size: pow2 up to 32, then multiples of 32."""
    if n <= 32:
        return _next_pow2(n)
    return ((n + 31) // 32) * 32


def _next_batch_size(b: int) -> int:
    """Next size up on the quantized batch grid (1,2,4,...,32,64,96,...)."""
    if b < 32:
        return _next_pow2(b + 1)
    return b + 32


def allocate_bucket_batches(
    demands: dict[int, int], buffer_size: int
) -> list[dict[int, int]]:
    """Split one global column budget across rank buckets.

    demands: {bucket_rank: n_models}. Returns "waves", each mapping
    bucket_rank -> batch and fitting the budget on its own; waves run one
    after another. A model wider than the whole budget still gets a slot.
    """
    waves: list[dict[int, int]] = []
    todo = sorted(demands.items())
    while todo:
        wave: dict[int, int] = {}
        budget = buffer_size
        rest: list[tuple[int, int]] = []
        for r, n in todo:
            if wave and budget < r:
                rest.append((r, n))
            else:
                wave[r] = 1
                budget -= r
        # Water-fill: grow the bucket with the fewest allocated columns one
        # quantized step at a time, never past its own demand.
        grew = True
        while grew:
            grew = False
            for r in sorted(wave, key=lambda rr: wave[rr] * rr):
                cap = _round_batch(demands[r])
                if wave[r] >= cap:
                    continue
                nb = min(_next_batch_size(wave[r]), cap)
                extra = (nb - wave[r]) * r
                if extra <= budget:
                    budget -= extra
                    wave[r] = nb
                    grew = True
                    break
        waves.append(wave)
        todo = rest
    return waves


# ------------------------------------------------------- eviction and stats


_COL_QUANTUM = 128


def _evict_col_indices(evicted, slot_meta):
    """Packed-column index map for ``_evicted_payload``: per evicted model
    its true-rank columns, padded to a multiple of ``_COL_QUANTUM``."""
    slot_list: list[int] = []
    col_list: list[int] = []
    offs: dict[int, int] = {}
    for slot in evicted:
        rank = slot_meta[slot][1]
        offs[slot] = len(slot_list)
        slot_list.extend([slot] * rank)
        col_list.extend(range(rank))
    n = len(slot_list)
    q = -(-max(n, 1) // _COL_QUANTUM) * _COL_QUANTUM
    pad = q - n
    slot_idx = np.asarray(slot_list + [slot_list[0]] * pad, np.int64)
    col_idx = np.asarray(col_list + [0] * pad, np.int64)
    return slot_idx, col_idx, offs


_WIRE = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _evicted_payload(state: SolverState, idx: torch.Tensor, wire_dtype: str | None):
    """The eviction stats, lam and every mode's columns of the evicted
    models as ONE byte tensor on the device (one fetch), and the (dtype,
    shape) of each piece. ``idx`` [2, n] holds the packed (slot, column)
    pairs (``_evict_col_indices``); ``wire_dtype`` rounds the factor payload
    to a half-width type for the transfer, lam stays in full precision."""
    si, ci = idx
    pieces = [pack_evict_stats(state), state.kt.lam[si, ci]]
    for f in state.kt.factors:
        g = f[si, :, ci]
        pieces.append(g.to(_WIRE[wire_dtype]) if wire_dtype is not None else g)
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in pieces])
    return flat, [(p.dtype, tuple(p.shape)) for p in pieces]


def _split_payload(raw: np.ndarray, layout) -> list[np.ndarray]:
    """The host pieces of a fetched ``_evicted_payload`` (bfloat16 widened
    to float32: numpy has no bfloat16)."""
    out, off = [], 0
    for dtype, shape in layout:
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        a = raw[off : off + n].view(NP_DTYPES[dtype]).reshape(shape)
        if dtype == torch.bfloat16:
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out.append(a)
        off += n
    return out


def _unpack_cols(kt_np: Ktensor, off: int, rank: int) -> Ktensor:
    """One model out of a packed-column gather (already in the queue
    dtype)."""
    return Ktensor(
        tuple(np.ascontiguousarray(f[off : off + rank].T) for f in kt_np.factors),
        kt_np.lam[off : off + rank].copy(),
    )


def _norms(x: torch.Tensor, with_jk: bool, tp=None):
    """(|X| on the device in x's dtype, leave-one-out norms per mode-0 fiber
    on the host or None). |X| reduces in float64: a float32 sum of squares
    over millions of entries on the CPU drifts by 1e-4 relative, which the
    FastALS error's |X|^2 - ... cancellation turns into a wrong fit. The
    leave-one-out norms are ``jackknife_norms``. Under tp (``tp``) ``x``
    holds this rank's rows of mode 0: the squared sums of its fibers are
    placed in the whole mode's zeros and summed over the tp group."""
    from .jackknife import jackknife_norms

    if tp is None:
        x_norm = torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64).to(x.dtype)
        return x_norm, (jackknife_norms(x).cpu().numpy() if with_jk else None)
    x64 = x.to(torch.float64)
    row_sq = torch.zeros(tp.size, dtype=torch.float64, device=x.device)
    row_sq[tp.start : tp.stop] = torch.sum(x64 * x64, dim=tuple(range(1, x.ndim)))
    row_sq = tp.sum(row_sq)
    total = torch.sum(row_sq)
    x_norm = torch.sqrt(total).to(x.dtype)
    if not with_jk:
        return x_norm, None
    return x_norm, torch.sqrt(torch.clamp(total - row_sq, min=0.0)).to(x.dtype).cpu().numpy()


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _queue_dtype(queue) -> np.dtype:
    """The dtype of a run: the first model's, where a spec without a dtype
    defers to the next entry (the JAX engine's rule); float32 when no entry
    names one (the port has no x64 switch)."""
    dt = np.dtype(np.float32)
    for kt in queue:
        if isinstance(kt, RandomKtensorSpec):
            if kt.dtype:
                dt = np.dtype(str(kt.dtype))
                break
        else:
            dt = _to_numpy(kt.lam).dtype
            break
    if dt not in _DTYPES:
        raise ValueError(f"queue dtype {dt}: float32 or float64 expected")
    return dt


def _check_queue(queue, modes: tuple) -> None:
    for i, kt in enumerate(queue):
        if isinstance(kt, RandomKtensorSpec):
            if tuple(kt.modes) != modes:
                raise ValueError(
                    f"queue[{i}]: spec modes {tuple(kt.modes)} do not match tensor shape {modes}"
                )
        elif not (hasattr(kt, "factors") and hasattr(kt, "lam")):
            raise TypeError(
                f"queue[{i}] ({type(kt).__name__}): a Ktensor or a RandomKtensorSpec expected "
                "(convert.spec_from_jax carries the JAX package's specs over)"
            )
        else:
            shapes = tuple(int(f.shape[0]) for f in kt.factors)
            if shapes != modes:
                raise ValueError(
                    f"queue[{i}]: model factor leading dims {shapes} do not match "
                    f"tensor shape {modes}"
                )


class SpecAhead:
    """A bucket's spec models generated on the device ahead of their
    intake: one ``spec_block`` per window of the queue (the window's
    requested specs and the next ``window`` queued ones), not one per
    refill, as the build is launch-bound (about 500 elementwise kernels
    whatever its batch). Rows are bit for bit ``spec_to_ktensor`` of their
    specs in any window and bucket."""

    def __init__(self, dq: collections.deque, r: int, modes: tuple, dtype: torch.dtype, uploader: Pinned,
                 window: int):
        self.dq, self.r, self.modes, self.dtype = dq, r, modes, dtype
        self.uploader, self.window = uploader, window
        self.rows: dict[int, int] = {}  # model id -> row of self.kt
        self.kt = None
        self.builds = 0

    def block(self, batch_slots) -> Ktensor:
        """The spec models of ``batch_slots`` (intake items, or None) as a
        block [bb, I_n, r]; zero rows where a slot holds no spec."""
        want = [it for it in batch_slots if it is not None and isinstance(it[1], RandomKtensorSpec)]
        if any(it[0] not in self.rows for it in want):
            ahead = [it for it in itertools.islice(self.dq, self.window) if isinstance(it[1], RandomKtensorSpec)]
            items = want + ahead
            # A last row of seed 0 and rank 0: zero factors and lam.
            seeds = np.array([np.uint32(it[1].seed) for it in items] + [0], np.int64)
            ranks = np.array([it[1].rank for it in items] + [0])
            meta = self.uploader.upload(np.concatenate([seeds, (np.arange(self.r) < ranks[:, None]).ravel()]))
            mask = meta[len(seeds):].view(len(seeds), self.r).bool()
            self.kt = spec_block(meta[: len(seeds)], mask, self.modes, self.dtype)
            self.rows = {it[0]: n for n, it in enumerate(items)}
            self.builds += 1
        zero = self.kt.lam.shape[0] - 1
        idx = [self.rows[it[0]] if it is not None and it[0] in self.rows else zero for it in batch_slots]
        idx_d = self.uploader.upload(np.asarray(idx, np.int64))
        return Ktensor(tuple(f.index_select(0, idx_d) for f in self.kt.factors), self.kt.lam.index_select(0, idx_d))


# ------------------------------------------------------------------ engine


class _Worker(NamedTuple):
    """What one bucket thread lends the bucket it runs: its CUDA stream
    (None on the CPU), the call's graph pool of that stream (``Graphs``:
    the buckets of one worker run one after another, so their graphs never
    replay at once; None where nothing is captured) and a pinned buffer
    each way."""

    stream: object
    graphs: Graphs | None
    uploader: Pinned
    fetcher: Pinned


_STREAMS: dict = {}  # device index -> (the bucket threads' streams, made once; their lock)
_STREAMS_LOCK = threading.Lock()


@contextlib.contextmanager
def _bucket_streams(dev: torch.device, n: int):
    """``n`` distinct CUDA streams of ``dev`` for the bucket threads (Nones
    on the CPU), the same ones in every call: the caching allocator keeps
    its free blocks per stream and PyTorch a cuBLAS workspace per handle
    and stream, so streams taken anew from PyTorch's pool in every call
    would hold device memory anew. A call holds the device's streams until
    its buckets have ended, and a call from another thread waits for them:
    a capture on a stream takes in every thread's work on it."""
    if dev.type != "cuda":
        yield [None] * n
        return
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _STREAMS_LOCK:
        have, busy = _STREAMS.setdefault(index, ([], threading.Lock()))
    with busy:
        for _ in range(64):  # PyTorch's pool cycles through 32 streams of a priority
            if len(have) >= n:
                break
            s = torch.cuda.Stream(index)
            if all(s.cuda_stream != h.cuda_stream for h in have):
                have.append(s)
        if len(have) < n:
            raise RuntimeError(f"no {n} distinct CUDA streams for the bucket threads")
        yield have[:n]


def _run_device(device, mesh, shard_mode0: bool) -> torch.device:
    """The device of a run: ``device`` (None: the card), or on a mesh the
    mesh's (``device`` must be None or that device)."""
    if mesh is None:
        if shard_mode0:
            raise ValueError("shard_mode0 needs a mesh")
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


def _bucket_methods(x_shape: tuple, r: int, b: int, params: CalsParams, dtype, dev, mesh, rows: tuple):
    """``_resolve_bucket_methods`` of a bucket at this rank's block of X
    (``x_shape``, ``rows`` = (r0, r1, I0)) and share of its batch ``b``; a
    mesh run never autotunes."""
    shard = Shard(mesh, b, rows)
    return _resolve_bucket_methods(x_shape, r, shard.hi - shard.lo, params, dtype, dev, autotune=mesh is None)


def precompile_buckets(
    x,
    queue: Sequence[Ktensor | RandomKtensorSpec],
    params: CalsParams = CalsParams(),
    has_jk: bool = False,
    mesh=None,
    shard_mode0: bool = False,
    device=None,
) -> None:
    """Warm, ahead of a timed ``cp_cals`` of these arguments, what its
    first call would pay for (port of
    ``cp_cals_tpu/solvers/cals.py:precompile_buckets``, which compiles
    every bucket's programs ahead; PyTorch compiles nothing): the kernels'
    build (nvcc, on the card), every bucket's MTTKRP methods at its
    allocated batch, one bucket after another (the lookup table, autotuned
    on the card where it misses: ``_resolve_bucket_methods``, as
    ``cp_cals`` resolves them, so the call finds exact entries and times
    nothing), the norm prologue (with ``has_jk`` the leave-one-out norms),
    and one eager iteration of every bucket's program, and of its polish,
    on a state of zero models at the bucket's batch (``_warm_programs``:
    on the H100 a first call after the rest still spent about half a
    second more than a later one on the kernels' and PyTorch's first
    launches, which such an iteration takes on itself; PERF.md), whose
    launches leave no trace in the launch and route counts. Results do not
    change. Idempotent: a process warms the norms and programs of given
    shapes, methods and params once (``_WARMED``), so a repeated call only
    looks its methods up again. On a mesh every rank calls it with the same
    arguments (the norm prologue and a tp iteration sum over the tp
    group)."""
    check_supported(params)
    dev = _run_device(device, mesh, shard_mode0)
    if not queue:
        return
    x = torch.as_tensor(x)
    modes = tuple(x.shape)
    t_dtype = _DTYPES[_queue_dtype(queue)]
    if dev.type == "cuda":
        _build.load("fused_mttkrp.cu")  # builds every kernel source at once
    tp = tp_rows(mesh, modes[0], shard_mode0)
    r0, r1 = (tp.start, tp.stop) if tp is not None else (0, modes[0])
    block = (r1 - r0,) + modes[1:]
    demands = collections.Counter(bucket_rank(kt.rank, params.bucket_ranks) for kt in queue)
    buckets = [(r, b) for wave in allocate_bucket_batches(dict(demands), params.buffer_size) for r, b in wave.items()]
    methods = [_bucket_methods(block, r, b, params, t_dtype, dev, mesh, (r0, r1, modes[0])) for r, b in buckets]
    shards = [(r, Shard(mesh, b, (r0, r1, modes[0]))) for r, b in buckets]
    key = (str(dev), modes, t_dtype, (r0, r1), tuple((r, s.lo, s.hi) for r, s in shards),
           tuple(methods), params, has_jk)
    if key in _WARMED:
        return
    x = x[r0:r1].to(device=dev, dtype=t_dtype).contiguous()
    x_norm, _ = _norms(x, has_jk, tp)
    before = launches.snapshot()
    try:
        _warm_programs(x, x_norm, shards, methods, params, has_jk, tp)
    finally:
        launches.take_added(before)  # no trace in the launch and route counts, as the autotune's
    _WARMED.add(key)


_WARMED: set = set()  # what precompile_buckets has warmed in this process (its key)


def _warm_programs(x, x_norm, buckets: list, methods: list, params: CalsParams, has_jk: bool, tp) -> None:
    """One eager iteration of each bucket's program (``buckets``: (rank,
    shard of its batch); ``methods``: its resolved MTTKRP methods), and of
    its polish where ``cp_cals`` runs one, on a state of zero models (an
    all-False rank mask: an identity normal matrix), as the JAX package's
    ``precompile_buckets`` runs each program once."""
    nnls = params.update_method == UpdateMethod.NNLS
    params = dataclasses.replace(params, debug=False)  # the debug hook would record the zero models
    p_params = dataclasses.replace(params, mttkrp_precision=None, line_search=False, tol_check_interval=0)
    chunked = params.sync_mode == "evict" and not params.always_evict_first
    layouts: dict = {}
    for (r, shard), (fast, polish) in zip(buckets, methods):
        b = shard.hi - shard.lo
        kt = Ktensor(tuple(torch.zeros((b, m, r), dtype=x.dtype, device=x.device) for m in x.shape),
                     torch.zeros((b, r), dtype=x.dtype, device=x.device))
        mask = torch.zeros((b, r), dtype=torch.bool, device=x.device)
        state = init_state(kt, x_norm, rank_mask=mask, nnls=nnls, line_search=params.line_search,
                           mixed_tol=params.tol_check_interval > 0, tp=tp)
        runs = [(params, fast)]
        if chunked and params.polish_iters > 0:
            runs.append((p_params, polish or fast))
        for p, m in runs:
            it = make_iteration(p, batched=True, mttkrp_methods=m, has_jk=has_jk, tp=tp)
            it(x, state, x_norm, it.prepare(x, layouts))


def cp_cals(
    x,
    queue: Sequence[Ktensor | RandomKtensorSpec],
    params: CalsParams = CalsParams(),
    jk_fibers: Sequence[int] | None = None,
    x_norms_jk=None,
    device=None,
    mesh=None,
    shard_mode0: bool = False,
    trace=None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    max_rounds_per_bucket: int | None = None,
) -> tuple[list[Ktensor], CalsReport]:
    """Fit every model in ``queue`` concurrently. Returns the fitted models
    (host NumPy Ktensors) in input order plus a report.

    x: dense tensor of 3 or more modes (NumPy or torch); it is cast to the
    queue's dtype.
    queue: Ktensors with NumPy or torch factors [I_n, R] and lam [R], or
    ``RandomKtensorSpec``s, whose factors are generated on the device.
    jk_fibers: optional per-model jackknifed mode-0 fiber (-1 = regular
    model); leave-one-out norms are computed once unless ``x_norms_jk`` is
    given. device: None means the CUDA card (raises without one); pass
    "cpu" to run the plain PyTorch versions of the kernels.
    trace: a ``utils.timers.RunTrace`` that takes one record per engine
    iteration (module docstring).
    checkpoint_dir: each bucket's solver state and finished models are
    written there after every eviction round; ``resume=True`` restarts an
    interrupted run from them (finished models from disk, in-flight models
    mid-solve, only the rest of the queue fitted). Resume needs the same
    tensor, queue and params.
    max_rounds_per_bucket: stop each bucket after this many eviction
    rounds; unfinished models are returned as None.
    mesh: a ``parallel.sharding.Mesh`` (every process of the run calls
    ``cp_cals`` with the same arguments; the module docstring): the model
    batch splits over dp, and with ``shard_mode0`` the tensor's mode 0 over
    tp. The run is on the mesh's device (``device`` must be None or that
    device). Every rank returns the whole result list.

    The buckets of a wave run in ``params.bucket_threads`` threads, each
    on a stream of its own (one thread on a mesh); a bucket's exception
    raises from here.
    """
    check_supported(params)
    dev = _run_device(device, mesh, shard_mode0)
    if not queue:
        return [], CalsReport()
    x = torch.as_tensor(x)
    modes = tuple(x.shape)
    if x.ndim < 3:
        raise ValueError(f"CP-CALS needs a tensor of >= 3 modes, got shape {modes}")
    _check_queue(queue, modes)
    np_dtype = _queue_dtype(queue)
    t_dtype = _DTYPES[np_dtype]
    # Under tp this rank's rows of mode 0 (of X and of every factor 0).
    tp = tp_rows(mesh, modes[0], shard_mode0)
    r0, r1 = (tp.start, tp.stop) if tp is not None else (0, modes[0])
    x = x[r0:r1].to(device=dev, dtype=t_dtype).contiguous()
    if jk_fibers is None:
        jk_fibers = [-1] * len(queue)
    has_jk = any(f >= 0 for f in jk_fibers)
    x_norm, loo = _norms(x, has_jk and x_norms_jk is None, tp)
    x_norm_f = float(x_norm)
    x_norms_jk = loo if x_norms_jk is None else _to_numpy(x_norms_jk)

    report = CalsReport(
        n_ktensors=len(queue), ktensor_comp_sum=sum(kt.rank for kt in queue)
    )
    buckets: dict[int, collections.deque] = collections.defaultdict(collections.deque)
    for i, (kt, jk) in enumerate(zip(queue, jk_fibers)):
        buckets[bucket_rank(kt.rank, params.bucket_ranks)].append((i, kt, int(jk)))
    waves = allocate_bucket_batches(
        {r: len(dq) for r, dq in buckets.items()}, params.buffer_size
    )
    # always_evict_first needs per-iteration host control, as in JAX.
    chunked = params.sync_mode == "evict" and not params.always_evict_first
    # The polish sweeps: full `precision`, no line search, no mixed-tier
    # check (polish keeps converged and iters), on X held at that tier.
    p_params = dataclasses.replace(params, mttkrp_precision=None, line_search=False, tol_check_interval=0)
    # The loop-invariant layouts of X, (mode, method, tier) -> tensor, shared
    # by every bucket (module docstring); none under mode_layouts="recompute".
    layouts: dict = {}
    resolved: dict = {}  # (bucket rank, batch) -> (methods, polish methods), resolved once
    programs: dict = {}  # (methods, polish methods) -> (iteration, held layouts, polish)

    def bucket_program(r: int, b: int):
        """The iteration, its held layouts and the polish of a bucket, by the
        bucket's MTTKRP methods (at this rank's block of X and share of the
        batch); buckets of the same methods share them."""
        if (r, b) not in resolved:
            resolved[(r, b)] = _bucket_methods(tuple(x.shape), r, b, params, t_dtype, dev, mesh, (r0, r1, modes[0]))
        key = resolved[(r, b)]
        if key not in programs:
            methods, polish_methods = key
            iteration = make_iteration(params, batched=True, mttkrp_methods=methods, has_jk=has_jk, tp=tp)
            polish = None
            if chunked and params.polish_iters > 0:
                p_iter = make_iteration(p_params, batched=True, mttkrp_methods=polish_methods or methods,
                                        has_jk=has_jk, tp=tp)
                polish = (p_iter, p_iter.prepare(x, layouts), params.polish_iters, params.polish_tol)
            programs[key] = (iteration, iteration.prepare(x, layouts), polish)
        return programs[key]

    # Every bucket's methods (autotuned on a miss) before any bucket runs,
    # in this thread: no autotune times against a running bucket.
    for wave in waves:
        for r, b in wave.items():
            bucket_program(r, b)
    results: dict[int, Ktensor] = {}
    mixed_tol = params.tol_check_interval > 0
    nnls = params.update_method == UpdateMethod.NNLS

    def build_block_state(uploader: Pinned, batch_slots, r: int, ahead: SpecAhead) -> SolverState:
        """A state of one row per intake item ((id, model, jk), or None for
        a dead slot): one upload through pinned memory (explicit models'
        factors and lam, the norms, then the int32 jackknife fibers, alive
        flags, spec flags and rank mask), the spec slots' factors from the
        bucket's models generated on the device (``ahead``, bit for bit
        ``spec_to_ktensor`` in any bucket), then the gramians of the
        initial guesses."""
        bb = len(batch_slots)
        specs = any(it is not None and isinstance(it[1], RandomKtensorSpec) for it in batch_slots)
        explicit = not specs or any(it is not None and not isinstance(it[1], RandomKtensorSpec) for it in batch_slots)
        rows = (r1 - r0,) + modes[1:]  # this rank's rows of mode 0
        parts = [np.zeros((bb, m, r), np_dtype) for m in rows] + [np.zeros((bb, r), np_dtype)] if explicit else []
        xnm = np.full((bb,), x_norm_f, np_dtype)
        jk_arr = np.full((bb,), -1, np.int32)
        alive = np.zeros((bb,), np.int32)
        spec = np.zeros((bb,), np.int32)
        rank_mask = np.zeros((bb, r), np.int32)
        for slot, item in enumerate(batch_slots):
            if item is None:
                continue
            _, kt, jk = item
            rk = kt.rank
            if isinstance(kt, RandomKtensorSpec):
                spec[slot] = 1
            else:
                for n, (dst, src) in enumerate(zip(parts, kt.factors)):
                    dst[slot, :, :rk] = _to_numpy(src)[r0:r1] if n == 0 else _to_numpy(src)
                parts[-1][slot, :rk] = _to_numpy(kt.lam)
            alive[slot] = 1
            rank_mask[slot, :rk] = 1
            jk_arr[slot] = jk
            if jk >= 0:
                xnm[slot] = float(x_norms_jk[jk])
        flat = np.concatenate([p.reshape(-1) for p in parts] + [xnm])
        meta = np.concatenate([jk_arr, alive, spec, rank_mask.reshape(-1)])
        raw = uploader.upload(np.concatenate([flat.view(np.uint8), meta.view(np.uint8)]))
        pieces = torch.split(raw[: flat.nbytes].view(t_dtype), [p.size for p in parts] + [bb])
        jk_d, alive_d, spec_d, mask_d = torch.split(raw[flat.nbytes :].view(torch.int32), [bb, bb, bb, bb * r])
        mask_d = mask_d.view(bb, r).bool()
        if explicit:
            kt_b = Ktensor(tuple(pc.view(bb, m, r) for pc, m in zip(pieces, rows)), pieces[len(modes)].view(bb, r))
        if specs:
            gen = ahead.block(batch_slots)
            gen = gen._replace(factors=(gen.factors[0][:, r0:r1],) + tuple(gen.factors[1:]))
            kt_b = tree_where(spec_d.bool(), gen, kt_b) if explicit else gen
        # Pre-zero each jackknife slot's left-out row (the solver re-zeroes
        # it after every mode-0 update), where this rank holds it.
        kt_b = kt_b._replace(factors=(scale_jk_rows(kt_b.factors[0], jk_d - r0, 0.0),) + tuple(kt_b.factors[1:]))
        return init_state(
            kt_b, x_norm, jk_fiber=jk_d, x_norm_model=pieces[-1],
            rank_mask=mask_d, alive=alive_d.bool(), nnls=nnls,
            line_search=params.line_search, mixed_tol=mixed_tol, tp=tp,
        )

    # A debug run reads the device on the host in every iteration, so it is
    # never captured; nor is an iteration that sums over a tp group (its
    # collectives).
    captured = chunked and dev.type == "cuda" and not params.debug and tp is None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    def resume_bucket(r: int, dq: collections.deque, paths, models: list):
        """The bucket's snapshot (``paths``: state and done archive): its
        slot metadata, this rank's part of its state on the device with
        alive following the slots' occupancy, the host's view of every
        slot (iteration counts, liveness) and its finished models' records,
        whose results come from the done archive. Finished and in-flight
        models leave ``dq``."""
        with open(paths[0] + ".meta.json") as fh:
            meta = json.load(fh).get("meta", {})
        slot_meta = [tuple(m) if m is not None else None for m in meta["slot_meta"]]
        done_meta = [list(m) for m in meta.get("done", [])]
        b = len(slot_meta)
        zeros = Ktensor(tuple(torch.zeros((b, m, r), dtype=t_dtype, device=dev) for m in modes),
                        torch.zeros((b, r), dtype=t_dtype, device=dev))
        template = init_state(zeros, x_norm, nnls=nnls, line_search=params.line_search, mixed_tol=mixed_tol)
        state, _ = load_state(paths[0], template)
        occupied = torch.as_tensor([m is not None for m in slot_meta], device=dev)
        state = state._replace(alive=state.alive & occupied)
        iters_h = _to_numpy(state.iters).astype(np.int64)
        live_h = _to_numpy(state.alive & ~state.converged)
        state = Shard(mesh, b, (r0, r1, modes[0])).take(state)
        skip = {int(m[0]) for m in done_meta} | {int(m[0]) for m in slot_meta if m is not None}
        for _ in range(len(dq)):
            item = dq.popleft()
            if item[0] not in skip:
                dq.append(item)
        if done_meta:
            with np.load(paths[1]) as done:
                for mid, rank, iters, fit, err in done_meta:
                    mid = int(mid)
                    results[mid] = Ktensor(tuple(done[f"{mid}_f{m}"] for m in range(len(modes))),
                                           done[f"{mid}_lam"])
                    models.append(CalsModelReport(id=mid, rank=int(rank), iters=int(iters),
                                                  fit=float(fit), approx_error=float(err)))
        return slot_meta, state, done_meta, iters_h, live_h

    def save_bucket(paths, r: int, loop, slot_meta, done_meta) -> None:
        """The bucket's state and slot metadata, and its finished models'
        factors (``done_meta``'s ids), the JAX engine's files and keys. On
        a mesh the state is gathered whole (every rank joins) and the
        coordinator alone writes."""
        leaves = loop.shard.gather_state(loop.state)
        if not is_coordinator():
            return
        arrays = {}
        for mid, *_ in done_meta:
            kt = results[mid]
            for m, f in enumerate(kt.factors):
                arrays[f"{mid}_f{m}"] = f
            arrays[f"{mid}_lam"] = kt.lam
        if arrays:
            np.savez(paths[1], **arrays)
        save_state(paths[0], loop.state, {
            "slot_meta": [list(m) if m is not None else None for m in slot_meta],
            "bucket_rank": r, "done": done_meta,
        }, leaves=leaves)

    def store_results(lam: np.ndarray, factors: list, done: list) -> None:
        """The models of ``done`` ((id, packed column offset, rank) each) out
        of an eviction round's packed lam and factors, into ``results``."""
        kt_np = Ktensor(tuple(f.astype(np_dtype, copy=False) for f in factors), lam.astype(np_dtype, copy=False))
        for i, off, rank in done:
            results[i] = _unpack_cols(kt_np, off, rank)

    def evict(loop, slot_idx: np.ndarray, col_idx: np.ndarray, done: list) -> np.ndarray:
        """An eviction round's host stats [5, B], and its models' lam and
        factors in the packed columns (``_evict_col_indices``) stored into
        ``results``, by one fetch."""
        loop.counts["stats_fetches"] += 1
        stats, lam, *factors = fetch_evicted(loop, slot_idx, col_idx)
        store_results(lam, factors, done)
        return stats

    def fetch_evicted(loop, slot_idx: np.ndarray, col_idx: np.ndarray) -> list:
        """The evicted models' stats [5, B], lam and factors in the packed
        columns, as host arrays in the run's dtypes (``_split_payload``), by
        one fetch. On a mesh each rank fetches the columns of its own slots
        (the rest read slot 0 and are zeroed) and its rows of factor 0,
        placed in zero-filled whole arrays, which one host all-reduce
        sums."""
        shard = loop.shard
        mine = shard.local(slot_idx)
        local_idx = np.where(mine, slot_idx - shard.lo, 0)
        idx = loop.uploader.upload(np.stack([local_idx, col_idx]))
        flat, layout = _evicted_payload(loop.state, idx, params.result_wire_dtype)
        stats, lam, *factors = _split_payload(loop.fetcher.fetch(flat), layout)
        if shard.trivial:
            return [stats, lam, *factors]
        cols = mine & shard.lead
        lam = np.where(cols, lam, 0).astype(lam.dtype)
        whole = [shard.gather_slots(stats, axis=1), lam]
        for n, f in enumerate(factors):
            if n == 0:
                f0 = np.zeros((f.shape[0], modes[0]), f.dtype)
                f0[mine & shard.rows_lead, r0:r1] = f[mine & shard.rows_lead]
                whole.append(f0)
            else:
                whole.append(np.where(cols[:, None], f, 0).astype(f.dtype))
        return shard.assemble(whole)

    def run_bucket(worker: _Worker, r: int, dq: collections.deque, b: int):
        """One bucket's whole run at its allocated batch ``b``, on its
        worker's stream (the current one), pinned buffers and graph pool."""
        iteration, prepared, polish = bucket_program(r, b)
        models: list[CalsModelReport] = []
        pt = {"setup": 0.0, "solve": 0.0, "evict": 0.0, "capture": 0.0}
        counts = dict(captures=0, replays=0, stats_fetches=0, polish_sweeps=0, checkpoints=0, capture_s=0.0)
        t0 = time.perf_counter()
        _, graphs, uploader, fetcher = worker
        ahead = SpecAhead(dq, r, modes, t_dtype, uploader, b)
        b_wave, n_compactions = b, 0
        paths = None
        if checkpoint_dir is not None:
            paths = (os.path.join(checkpoint_dir, f"bucket_r{r}"), os.path.join(checkpoint_dir, f"done_r{r}.npz"))
        done_meta: list = []  # [id, rank, iters, fit, error] of the bucket's finished models
        if resume and paths is not None and os.path.exists(paths[0] + ".meta.json"):
            slot_meta, state, done_meta, iters_h, live_h = resume_bucket(r, dq, paths, models)
            b = len(slot_meta)
            shard = Shard(mesh, b, (r0, r1, modes[0]))
            n_compactions = (b_wave // b).bit_length() - 1  # snapshots are taken after compaction
        else:
            slot_meta: list = [None] * b  # (id, rank, jk) per slot
            shard = Shard(mesh, b, (r0, r1, modes[0]))
            batch = [dq.popleft() for _ in range(min(b, len(dq)))]
            for slot, (i, kt, jk) in enumerate(batch):
                slot_meta[slot] = (i, kt.rank, jk)
            batch += [None] * (b - len(batch))
            state = build_block_state(uploader, batch[shard.lo : shard.hi], r, ahead)
            iters_h = np.zeros(b, np.int64)
            live_h = np.array([m is not None for m in slot_meta])
        if chunked:
            loop = ChunkLoop(iteration, x, x_norm, prepared, state, iters_h, live_h, counts, uploader, fetcher,
                             params, polish, graphs, traced=trace is not None, shard=shard)
        else:
            loop = IterLoop(iteration, x, x_norm, prepared, state, iters_h, live_h,
                            counts, uploader, fetcher, shard)
        pt["setup"] = time.perf_counter() - t0
        engine_iters = rounds = 0
        flops_per_col = als_iteration_flops(modes, r, 1) / r

        while any(m is not None for m in slot_meta):
            t0 = time.perf_counter()
            stats, k = loop.advance(params.evict_batch)
            first = engine_iters + 1
            engine_iters += k
            if trace is not None:
                if chunked:  # the device's counts, each chunk's wall shared by its iterations
                    rows = [(*row, wall) for chunk, wall in loop.trace_chunks for row in chunk]
                    loop.trace_chunks.clear()
                else:  # one iteration, whose live slots the host knows
                    live = [m for m in slot_meta if m is not None]
                    rows = [(len(live), sum(m[1] for m in live), time.perf_counter() - t0)]
                for it, (n_live, n_cols, wall) in enumerate(rows, first):
                    trace.add(IterationRecord(
                        iteration=it, active_models=int(n_live), active_columns=int(n_cols),
                        flops=int(flops_per_col * int(n_cols)), wall_s=wall, bucket=r))
            conv = stats[0] != 0
            if params.always_evict_first:
                # Defrag-stress knob (reference cals.cpp:346-352): evict the
                # leftmost occupied slot every iteration, converged or not.
                conv = np.zeros(b, bool)
                conv[next(s for s in range(b) if slot_meta[s] is not None)] = True
            evicted = [s for s in range(b) if slot_meta[s] is not None and conv[s]]
            if evicted and polish is not None:
                loop.polish()  # the end of the run-until-evict, as in the JAX program
            pt["solve"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            keep = np.ones(b, bool)
            if evicted:
                slot_idx, col_idx, offs = _evict_col_indices(evicted, slot_meta)
                stats = evict(loop, slot_idx, col_idx, [(slot_meta[s][0], offs[s], slot_meta[s][1]) for s in evicted])
                refill_slots: list = []
                refill_items: list = []
                for slot in evicted:
                    i, rank, _ = slot_meta[slot]
                    rep_m = CalsModelReport(
                        id=i, rank=rank, iters=int(stats[1][slot]),
                        fit=float(stats[2][slot]), approx_error=float(stats[3][slot]),
                    )
                    models.append(rep_m)
                    done_meta.append([i, rank, rep_m.iters, rep_m.fit, rep_m.approx_error])
                    slot_meta[slot] = None
                    if dq:
                        item = dq.popleft()
                        slot_meta[slot] = (item[0], item[1].rank, item[2])
                        refill_slots.append(slot)
                        refill_items.append(item)
                    else:
                        keep[slot] = False
                if refill_slots:
                    # Batched refill: one build of the fresh models' rows
                    # (this rank's slots' only), written into their slots.
                    slots = np.asarray(refill_slots)
                    mine = [it for it, m in zip(refill_items, loop.shard.local(slots)) if m]
                    loop.refill(slots, build_block_state(uploader, mine, r, ahead) if mine else None)
            if not keep.all():
                loop.kill(keep)
            # Tail compaction: once the queue is drained and at most half the
            # slots are live, repack live slots into a half-size batch.
            n_live = sum(m is not None for m in slot_meta)
            while (
                not dq and b > 1 and n_live <= b // 2
                and n_compactions < params.tail_compaction_depth
            ):
                live_idx = [s for s in range(b) if slot_meta[s] is not None]
                pad_idx = [s for s in range(b) if slot_meta[s] is None]
                idx = live_idx + pad_idx[: b // 2 - len(live_idx)]
                loop = loop.compacted(idx)
                slot_meta = [slot_meta[s] for s in idx]
                b //= 2
                n_compactions += 1
            pt["evict"] += time.perf_counter() - t0
            if evicted and paths is not None:
                # After the eviction's fetch, refill, kill and compaction:
                # the state and slot_meta describe the same slots.
                t0 = time.perf_counter()
                save_bucket(paths, r, loop, slot_meta, done_meta)
                counts["checkpoints"] += 1
                pt["checkpoint"] = pt.get("checkpoint", 0.0) + time.perf_counter() - t0
            if evicted:
                rounds += 1
                if max_rounds_per_bucket is not None and rounds >= max_rounds_per_bucket:
                    break
        pt["capture"] = counts.pop("capture_s")
        counts["spec_builds"] = ahead.builds
        pt["solve"] -= pt["capture"]
        return models, pt, engine_iters, counts

    # One worker per bucket thread (``_Worker``), each lent to one bucket at
    # a time, so a running bucket has its stream, graph pool and pinned
    # buffers to itself. The streams first wait on this call's stream, which
    # made x, the norms and the held layouts, and the call's stream waits on
    # them before the call returns. No record_stream is needed: what the
    # call's stream allocated lives until the call returns, after that
    # wait, and a bucket frees only what its own stream allocated, which
    # only later work of that stream can reuse.
    most = 1 if mesh is not None else max(1, min(params.bucket_threads, max(len(w) for w in waves)))

    def on_worker(item):
        """``run_bucket`` of ``item`` with a free worker."""
        worker = workers.get()
        try:
            if dev.type != "cuda":
                return run_bucket(worker, *item)
            with torch.cuda.device(dev), torch.cuda.stream(worker.stream):
                return run_bucket(worker, *item)
        finally:
            workers.put(worker)

    def in_thread(item):
        """``on_worker`` in a bucket thread, whose counts then join the
        threads' common part (the thread ends with its executor)."""
        try:
            return on_worker(item)
        finally:
            launches.retire_thread()

    with _bucket_streams(dev, most) as streams:
        workers: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        for s in streams:
            workers.put(_Worker(s, Graphs() if captured else None, Pinned(dev), Pinned(dev)))
        if dev.type == "cuda":
            call_stream = torch.cuda.current_stream(dev)
            for s in streams:
                s.wait_stream(call_stream)
        for wave in waves:
            # Largest-work-first order, as in the JAX engine: the widest
            # bucket starts first.
            items = sorted(
                ((r, buckets[r], b) for r, b in wave.items()),
                key=lambda t: (-t[0] * t[2], t[0]),
            )
            n_threads = min(most, len(items))
            if n_threads > 1:
                with concurrent.futures.ThreadPoolExecutor(n_threads, "cals-bucket") as ex:
                    outs = list(ex.map(in_thread, items))
            else:
                outs = [on_worker(item) for item in items]
            for (r, _, _), (models, pt, engine_iters, counts) in zip(items, outs):
                report.models.extend(models)
                report.phase_times[r] = pt
                if trace is not None:
                    for k, v in pt.items():
                        trace.phase_totals[k] += v
                report.engine_iterations[r] = report.engine_iterations.get(r, 0) + engine_iters
                report.loop_counts[r] = counts
        if dev.type == "cuda":
            for s in streams:
                call_stream.wait_stream(s)

    report.models.sort(key=lambda m: m.id)
    # Unfinished models (max_rounds_per_bucket) are None.
    return [results.get(i) for i in range(len(queue))], report
