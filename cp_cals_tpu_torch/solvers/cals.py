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

``_Plan`` is what a call decides from its arguments alone, the same for
``cp_cals`` and ``precompile_buckets``: the device, dtypes, this rank's
block of X, the bucket queues and waves, the loop kind, the polish, the
layout policy, and each bucket's MTTKRP methods and programs. ``_Bucket``
is one bucket's run and the host's view of its slots: intake, then rounds
of solve, evict (store, refill, kill, tail compaction) and checkpoint,
each step in its span (``utils/timers.py``; PERF.md §3 lists them).
``cp_cals`` holds the streams and kept graphs, X's copy and the norms, and
runs the buckets wave by wave. The loop is ``graph_loop.ChunkLoop`` by
default (``sync_mode="evict"``: CUDA graph replays in chunks, one stats
fetch a chunk, the polish; eager, one iteration a chunk, under ``debug``,
whose hook reads every iteration), ``IterLoop`` under ``sync_mode="iter"``
or ``always_evict_first`` (one eager iteration a round: the JAX package's
per-iteration mode, the eager reference on the card).

The buckets of a wave run in ``bucket_threads`` host threads (the JAX
engine's design), the widest bucket first, each bucket on a CUDA stream
of its own with its own graph memory pool and pinned buffers (its
thread's, which the buckets a thread runs one after another share), so
that one bucket's host work (stats fetches, evictions, refills, captures)
runs while another's iterations run on the card. Python holds the GIL,
so host work overlaps device work, not other host work. Buckets share no
state on the device: a threaded run's results are the serial run's bit
for bit, and its launch counts (``launches.py``, per thread) the same. On
a mesh the buckets run one after another (the SPMD host loop's
collectives keep program order). The default is one thread (the JAX
package's is 4): on the H100 the bench workload is bound by host Python,
and four threads ran it 1.65-1.92x slower than one (PERF.md).

Each eviction round fetches its stats, lam and factors in one fetch and
stores its models at once. The JAX engine defers the factors' fetch to a
pool of 4 threads and times their collection after the last bucket
(``CalsReport.materialize_s``); on the H100 a deferred round was no faster
(one sync a round either way, for a payload of a few KB; PERF.md), so the
port has no such collection and its report no such field.

A queue holds explicit Ktensors or ``RandomKtensorSpec``s, whose factors
are generated on the device (``ktensor.spec_block``: the JAX package's
threefry draws, bit for bit ``spec_to_ktensor`` of the spec in any bucket)
a window of the bucket's queue ahead of intake (``SpecAhead``), so that a
refill takes rows already built; explicit and spec models mix in one
block.

``trace`` takes one ``IterationRecord`` per engine iteration, with the
rows the loop gives (``graph_loop``); records of threaded buckets
interleave, each with its bucket. ``checkpoint_dir`` snapshots each bucket
(``utils/checkpoint.BucketSnapshot``: its ``SolverState``, slot metadata
and finished models, the JAX engine's files and keys) after every
eviction round, after the round's refill, kill and tail compaction;
``resume`` rebuilds a bucket's loop from its snapshot, which captures its
graphs anew.

Under ``mttkrp_method=AUTO`` every bucket takes its MTTKRP methods per
mode from the lookup table at its (rank, allocated batch), per tier
(``_resolve_bucket_methods``); on the card a missing entry is autotuned and
stored first, every bucket's before any bucket runs (serially, before any
thread starts), so no autotune times against a running bucket. The held X
layouts are one per (mode, method, tier) that some bucket needs, shared by
the buckets that agree, each about |X| (at 500^3 in float32, 500 MB a
layout, up to 6 GB for 3 modes), and kept with the captured graphs that
read them (below), or until the call returns where nothing is captured.

On a mesh (``mesh``, ``parallel/sharding.py``; one process per device)
every rank runs this function with the same arguments. dp gives each rank
its share of every bucket's slots (a bucket whose batch dp does not divide
is replicated); under ``shard_mode0`` tp gives it its rows of mode 0, of X
and of every factor 0, and the iteration sums over the tp group
(``solvers/iteration.py``). The host loop is SPMD (``graph_loop``): every
rank takes the same evictions, refills (each building only its own slots'
rows), kills and compactions, gathers the evicted results, and returns the
whole result list and the report a single process would. A tp bucket runs
uncaptured (``captures`` 0): its sums are collectives. The checkpoint
gathers each bucket's state and the coordinator alone writes; resume loads
it on every rank. Under AUTO a mesh run reads the table at the rank's
block and batch and never autotunes (ranks would time against each other
and write one table at once).

The CUDA graphs of the chunk loops outlive the call (``GraphCache``, one
per device): each bucket stream keeps the graphs captured on it and every
buffer they read or write (``graph_loop.Graphs``), and the device keeps X
as cast to the run's dtype, |X| and the held layouts. A later call of the
same call-level key (X's shape, dtype and device, the layout policy, the
whole ``CalsParams``, whether any model is a jackknife one, whether the
call is traced, and the launch observers, ``launches.TALLIES``) copies its
X and |X| into the kept ones, rebuilds the held layouts in place, and
replays each loop whose bucket rank, batch and methods were kept on its
stream: no eager first call, no capture. A call of another key, or
``release_graphs()``, releases them first. Results and launch counts are
those of a fresh capture.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import os
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build, launches
from ..config import CalsParams, UpdateMethod, check_supported, resolve_layouts
from ..device import resolve_device
from ..ktensor import Ktensor, RandomKtensorSpec, scale_jk_rows, spec_block
from ..ops.mttkrp import als_iteration_flops
from ..parallel.distributed import is_coordinator
from ..parallel.sharding import Shard, tp_rows
from ..utils import timers
from ..utils.checkpoint import BucketSnapshot
from ..utils.timers import IterationRecord
from .graph_loop import NP_DTYPES, ChunkLoop, Graphs, IterLoop, Pinned, pack_evict_stats
from .iteration import make_iteration, refresh_layouts
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
    # bucket rank -> host seconds: "setup" (span bucket.intake), "solve"
    # (bucket.solve less loop.capture), "evict" (evict.round), "capture"
    # (loop.capture: each graph's eager first call and its capture), and
    # "checkpoint" (bucket.checkpoint) where checkpoints are written.
    phase_times: dict = field(default_factory=dict)
    # bucket rank -> the loop's counts: graph captures, kept graphs taken
    # (graph_reuses: the counter graphs.reused) and replays, stats fetches
    # (one per chunk, per polish check, per eviction round: the counters
    # fetches.chunk + fetches.polish + fetches.evict), polish
    # sweeps, checkpoints written (one per eviction round under
    # checkpoint_dir), and spec blocks built.
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
    (None on the CPU), the graphs kept on that stream (``Graphs``: the
    buckets of one worker run one after another, so their graphs never
    replay at once; None where nothing is captured) and a pinned buffer
    each way."""

    stream: object
    graphs: Graphs | None
    uploader: Pinned
    fetcher: Pinned


class GraphCache:
    """The CUDA graphs that one device's engine calls keep (module
    docstring): the call-level key they were captured under, X as cast to
    the run's dtype, |X|, the held layouts (``iteration.prepare``'s dict)
    and each bucket stream's ``Graphs``, by the stream's slot. Used under
    the device's stream lock (``_bucket_streams``)."""

    def __init__(self):
        self.release()

    def release(self) -> None:
        """Drops every kept graph and buffer."""
        self.key = self.x = self.x_norm = None
        self.layouts: dict = {}
        self.slots: list = []
        self.observers: tuple = ()

    def admit(self, key) -> None:
        """A call of call-level ``key``: what was kept under another key is
        released, before the call allocates."""
        if key != self.key:
            self.release()
            self.key = key
            self.observers = tuple(launches.TALLIES)  # keeps the ids in the key in use

    def inputs(self, x: torch.Tensor, x_norm: torch.Tensor, owned: bool):
        """(X, |X|, held layouts) of the admitted call: the kept ones, with
        the call's ``x`` and ``x_norm`` copied in and the layouts rebuilt in
        place (stream-ordered), or else the call's own, now kept (``x``
        copied where the caller holds it: ``owned`` False)."""
        if self.x is None:
            self.x, self.x_norm = (x if owned else x.clone()), x_norm
        else:
            self.x.copy_(x)
            self.x_norm.copy_(x_norm)
            refresh_layouts(self.x, self.layouts)
        return self.x, self.x_norm, self.layouts

    def graphs(self, n: int) -> list[Graphs]:
        """The kept graphs of the first ``n`` stream slots."""
        while len(self.slots) < n:
            self.slots.append(Graphs())
        return self.slots[:n]


_STREAMS: dict = {}  # device index -> (the bucket threads' streams, made once; their lock; the GraphCache)
_STREAMS_LOCK = threading.Lock()


@contextlib.contextmanager
def _bucket_streams(dev: torch.device, n: int):
    """``n`` distinct CUDA streams of ``dev`` for the bucket threads, the
    same ones in every call, and the device's ``GraphCache`` (Nones and
    None on the CPU): the caching allocator keeps its free blocks per
    stream and PyTorch a cuBLAS workspace per handle and stream, so streams
    taken anew from PyTorch's pool in every call would hold device memory
    anew, and the kept graphs replay on their streams. A call holds the
    device's streams and cache until its buckets have ended, and a call
    from another thread waits for them: a capture on a stream takes in
    every thread's work on it."""
    if dev.type != "cuda":
        yield [None] * n, None
        return
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _STREAMS_LOCK:
        have, busy, cache = _STREAMS.setdefault(index, ([], threading.Lock(), GraphCache()))
    with busy:
        for _ in range(64):  # PyTorch's pool cycles through 32 streams of a priority
            if len(have) >= n:
                break
            s = torch.cuda.Stream(index)
            if all(s.cuda_stream != h.cuda_stream for h in have):
                have.append(s)
        if len(have) < n:
            raise RuntimeError(f"no {n} distinct CUDA streams for the bucket threads")
        yield have[:n], cache


def release_graphs() -> None:
    """Releases the CUDA graphs that engine calls keep on every device, with
    X's copy, the held layouts and the buffers the graphs read (module
    docstring), after any call that holds them has ended. Their memory goes
    back to PyTorch's caching allocator (``torch.cuda.empty_cache()`` hands
    it to the driver); the next call captures anew."""
    with _STREAMS_LOCK:
        devices = list(_STREAMS.values())
    for _, busy, cache in devices:
        with busy:
            cache.release()


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


class _Plan:
    """What an engine call decides from its arguments alone, built alike by
    ``cp_cals`` and ``precompile_buckets`` (module docstring); each
    bucket's MTTKRP methods and programs are made once, at first use."""

    def __init__(self, x: torch.Tensor, queue, params: CalsParams, jk_fibers, dev: torch.device, mesh,
                 shard_mode0: bool):
        self.params, self.dev, self.mesh = params, dev, mesh
        self.modes = tuple(x.shape)
        self.np_dtype = _queue_dtype(queue)
        self.t_dtype = _DTYPES[self.np_dtype]
        # Under tp this rank's rows of mode 0 (of X and of every factor 0).
        self.tp = tp_rows(mesh, self.modes[0], shard_mode0)
        self.r0, self.r1 = (self.tp.start, self.tp.stop) if self.tp is not None else (0, self.modes[0])
        self.block = (self.r1 - self.r0,) + self.modes[1:]
        jk_fibers = [-1] * len(queue) if jk_fibers is None else jk_fibers
        self.has_jk = any(f >= 0 for f in jk_fibers)
        # Each bucket rank's queue of (id, model, jackknife fiber) items.
        self.queues: dict[int, collections.deque] = collections.defaultdict(collections.deque)
        for i, (kt, jk) in enumerate(zip(queue, jk_fibers)):
            self.queues[bucket_rank(kt.rank, params.bucket_ranks)].append((i, kt, int(jk)))
        self.waves = allocate_bucket_batches({r: len(dq) for r, dq in self.queues.items()}, params.buffer_size)
        self.buckets = [(r, b) for wave in self.waves for r, b in wave.items()]
        self.nnls = params.update_method == UpdateMethod.NNLS
        self.mixed_tol = params.tol_check_interval > 0
        # The loop kind (ChunkLoop, else IterLoop): always_evict_first needs
        # per-iteration host control, as in JAX, and IterLoop applies it.
        self.evict_first = params.always_evict_first
        self.chunked = params.sync_mode == "evict" and not self.evict_first
        # The polish sweeps, at the end of each run-until-evict: full
        # `precision`, no line search, no mixed-tier check (polish keeps
        # converged and iters), on X held at that tier.
        self.polishes = self.chunked and params.polish_iters > 0
        self.polish_params = dataclasses.replace(params, mttkrp_precision=None, line_search=False,
                                                 tol_check_interval=0)
        # Resolved on this rank's block of X: the kept graphs' key and every
        # bucket's layouts agree on it.
        self.policy = resolve_layouts(params, torch.empty(self.block, dtype=self.t_dtype, device="meta"), dev)
        self._methods: dict = {}  # (bucket rank, batch) -> (methods, polish methods)
        self._programs: dict = {}  # (methods, polish methods) -> (iteration, held layouts, polish)

    def shard(self, b: int) -> Shard:
        """This rank's share of a bucket of batch ``b``."""
        return Shard(self.mesh, b, (self.r0, self.r1, self.modes[0]))

    def methods(self, r: int, b: int) -> tuple:
        """``_resolve_bucket_methods`` of a bucket at this rank's block of X
        and share of its batch ``b``, once; a mesh run never autotunes."""
        if (r, b) not in self._methods:
            shard = self.shard(b)
            self._methods[(r, b)] = _resolve_bucket_methods(self.block, r, shard.hi - shard.lo, self.params,
                                                            self.t_dtype, self.dev, autotune=self.mesh is None)
        return self._methods[(r, b)]

    def program(self, key: tuple, x: torch.Tensor, layouts: dict) -> tuple:
        """The iteration of a bucket of MTTKRP methods ``key`` (``methods``),
        its held layouts (in ``layouts``, shared by every bucket of the
        call) and its polish (None, or (the polish iteration, its held
        layouts, polish_iters, polish_tol)); buckets of the same methods
        share them."""
        if key not in self._programs:
            methods, polish_methods = key
            iteration = make_iteration(self.params, batched=True, mttkrp_methods=methods, has_jk=self.has_jk,
                                       tp=self.tp)
            polish = None
            if self.polishes:
                p_iter = make_iteration(self.polish_params, batched=True, mttkrp_methods=polish_methods or methods,
                                        has_jk=self.has_jk, tp=self.tp)
                polish = (p_iter, p_iter.prepare(x, layouts, self.policy), self.params.polish_iters,
                          self.params.polish_tol)
            self._programs[key] = (iteration, iteration.prepare(x, layouts, self.policy), polish)
        return self._programs[key]


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
    ``cp_cals_tpu/solvers/cals.py:precompile_buckets``; PyTorch compiles
    nothing), from the call's own plan: the kernels' build (nvcc, on the
    card), every bucket's MTTKRP methods (autotuned on the card where the
    table misses, so the call times nothing), the norm prologue (with
    ``has_jk`` the leave-one-out norms), and one eager iteration of every
    bucket's program, and of its polish, on zero models
    (``_warm_programs``: on the H100 a first call after the rest still spent
    about half a second more than a later one on the kernels' and
    PyTorch's first launches; PERF.md), which leaves no trace in the launch
    and route counts. Results do not change. A process warms given shapes,
    methods and params once (``_WARMED``); a repeated call only looks its
    methods up again. On a mesh every rank calls it with the same
    arguments (the norms and a tp iteration are collectives)."""
    check_supported(params)
    dev = _run_device(device, mesh, shard_mode0)
    if not queue:
        return
    x = torch.as_tensor(x)
    # The call's plan, whose programs leave out the debug hook (it would
    # record the warm-up's zero models); a jackknife model's fiber does not
    # shape a program.
    plan = _Plan(x, queue, dataclasses.replace(params, debug=False), [0] * len(queue) if has_jk else None, dev,
                 mesh, shard_mode0)
    if dev.type == "cuda":
        _build.load("fused_mttkrp.cu")  # builds every kernel source at once
    methods = [plan.methods(r, b) for r, b in plan.buckets]
    key = (str(dev), plan.modes, plan.t_dtype, (plan.r0, plan.r1),
           tuple((r, plan.shard(b).lo, plan.shard(b).hi) for r, b in plan.buckets), tuple(methods), params, has_jk)
    if key in _WARMED:
        return
    x = x[plan.r0 : plan.r1].to(device=dev, dtype=plan.t_dtype).contiguous()
    x_norm, _ = _norms(x, has_jk, plan.tp)
    before = launches.snapshot()
    try:
        _warm_programs(plan, x, x_norm, methods)
    finally:
        launches.take_added(before)  # no trace in the launch and route counts, as the autotune's
    _WARMED.add(key)


_WARMED: set = set()  # what precompile_buckets has warmed in this process (its key)


def _warm_programs(plan: _Plan, x, x_norm, methods: list) -> None:
    """One eager iteration of each bucket's program (``plan.buckets``, whose
    resolved MTTKRP methods are ``methods``), and of its polish where it
    polishes, on a state of zero models (an all-False rank mask: an
    identity normal matrix) at this rank's share of its batch, as the JAX
    package's ``precompile_buckets`` runs each program once."""
    layouts: dict = {}
    for (r, b), key in zip(plan.buckets, methods):
        shard = plan.shard(b)
        bb = shard.hi - shard.lo
        kt = Ktensor(tuple(torch.zeros((bb, m, r), dtype=x.dtype, device=x.device) for m in x.shape),
                     torch.zeros((bb, r), dtype=x.dtype, device=x.device))
        mask = torch.zeros((bb, r), dtype=torch.bool, device=x.device)
        state = init_state(kt, x_norm, rank_mask=mask, nnls=plan.nnls, line_search=plan.params.line_search,
                           mixed_tol=plan.mixed_tol, tp=plan.tp)
        iteration, prepared, polish = plan.program(key, x, layouts)
        iteration(x, state, x_norm, prepared)
        if polish is not None:
            polish[0](x, state, x_norm, polish[1])


# What one cp_cals call lends each of its buckets beside the plan: X (this
# rank's rows, on the device, in the run's dtype), |X| on the device and on
# the host, the leave-one-out norms (host, or None), the held layouts, the
# results by model id (every bucket's), and the call's trace, checkpoint dir,
# resume flag and round limit.
_Call = collections.namedtuple(
    "_Call", "x x_norm x_norm_f x_norms_jk layouts results trace checkpoint_dir resume max_rounds")


class _Bucket:
    """One bucket's run at its allocated batch ``b``, on its worker's
    stream (the current one), pinned buffers and kept graphs, and the
    host's view of it: ``slot_meta`` ((id, rank, jk) per slot, None where
    vacant), the finished models' reports and records (``done_meta``: [id,
    rank, iters, fit, error] each), the batch, the loop and the Totals."""

    def __init__(self, plan: _Plan, call: _Call, worker: _Worker, r: int, dq: collections.deque, b: int):
        self.plan, self.call, self.worker = plan, call, worker
        self.r, self.dq, self.b = r, dq, b
        self.models, self.done_meta = [], []  # CalsModelReports; [id, rank, iters, fit, error] each
        self.tot = timers.Totals()
        self.engine_iters = self.n_compactions = 0
        self.flops_per_col = als_iteration_flops(plan.modes, r, 1) / r
        self.snapshot = BucketSnapshot(call.checkpoint_dir, r) if call.checkpoint_dir is not None else None

    def run(self) -> "_Bucket":
        """Intake, then rounds of solve, evict and checkpoint while a slot
        holds a model (or up to the call's round limit)."""
        self.iteration, self.prepared, self.polish = self.plan.program(self.plan.methods(self.r, self.b),
                                                                       self.call.x, self.call.layouts)
        with self.tot.span("bucket.intake"):
            self.intake()
        rounds = 0
        while any(m is not None for m in self.slot_meta):
            with self.tot.span("bucket.solve"):
                evicted = self.solve()
            with self.tot.span("evict.round"):
                self.evict(evicted)
            if evicted and self.snapshot is not None:
                with self.tot.span("bucket.checkpoint"):
                    self.checkpoint()
            if evicted:
                rounds += 1
                if self.call.max_rounds is not None and rounds >= self.call.max_rounds:
                    break
        return self

    def intake(self) -> None:
        """The first batch's state, or the state of the bucket's snapshot
        where the call resumes one, and the loop that runs it."""
        plan, call = self.plan, self.call
        _, graphs, uploader, fetcher = self.worker
        self.ahead = SpecAhead(self.dq, self.r, plan.modes, plan.t_dtype, uploader, self.b)
        resumed = self.resume() if call.resume and self.snapshot is not None else None
        if resumed is not None:
            state, iters_h, live_h = resumed
        else:
            batch = [self.dq.popleft() for _ in range(min(self.b, len(self.dq)))]
            batch += [None] * (self.b - len(batch))
            self.slot_meta = [None if it is None else (it[0], it[1].rank, it[2]) for it in batch]
            shard = plan.shard(self.b)
            state = self.block_state(batch[shard.lo : shard.hi])
            iters_h = np.zeros(self.b, np.int64)
            live_h = np.array([m is not None for m in self.slot_meta])
        args = (self.iteration, call.x, call.x_norm, self.prepared, state, iters_h, live_h, self.tot, uploader,
                fetcher)
        if plan.chunked:
            self.loop = ChunkLoop(*args, plan.params, self.polish, graphs, traced=call.trace is not None,
                                  shard=plan.shard(self.b))
        else:
            self.loop = IterLoop(*args, plan.shard(self.b), evict_first=plan.evict_first)

    def zero_state(self, b: int) -> SolverState:
        """A whole state of ``b`` zero models: what a snapshot loads into."""
        plan, r = self.plan, self.r
        zeros = Ktensor(tuple(torch.zeros((b, m, r), dtype=plan.t_dtype, device=plan.dev) for m in plan.modes),
                        torch.zeros((b, r), dtype=plan.t_dtype, device=plan.dev))
        return init_state(zeros, self.call.x_norm, nnls=plan.nnls, line_search=plan.params.line_search,
                          mixed_tol=plan.mixed_tol)

    def resume(self) -> tuple | None:
        """(This rank's part of the snapshot's state, with alive following
        the slots' occupancy, every slot's iteration count and liveness),
        and the slots and finished models from it; None without one."""
        plan = self.plan
        snap = self.snapshot.load(self.dq, self.zero_state, len(plan.modes))
        if snap is None:
            return None
        self.slot_meta, self.done_meta, state, done = snap
        # Snapshots are taken after compaction.
        self.n_compactions = (self.b // len(self.slot_meta)).bit_length() - 1
        self.b = len(self.slot_meta)
        occupied = torch.as_tensor([m is not None for m in self.slot_meta], device=plan.dev)
        state = state._replace(alive=state.alive & occupied)
        iters_h = _to_numpy(state.iters).astype(np.int64)
        live_h = _to_numpy(state.alive & ~state.converged)
        self.call.results.update(done)
        self.models += [CalsModelReport(id=int(mid), rank=int(rank), iters=int(iters), fit=float(fit),
                                        approx_error=float(err)) for mid, rank, iters, fit, err in self.done_meta]
        return plan.shard(self.b).take(state), iters_h, live_h

    def block_state(self, batch_slots) -> SolverState:
        """A state of one row per intake item ((id, model, jk), or None for
        a dead slot): one upload through pinned memory (explicit models'
        factors and lam, the norms, then the int32 jackknife fibers, alive
        flags, spec flags and rank mask), the spec slots' factors from the
        bucket's models generated on the device (``SpecAhead``, bit for bit
        ``spec_to_ktensor`` in any bucket), then the gramians of the
        initial guesses."""
        plan, r, r0, r1, np_dtype = self.plan, self.r, self.plan.r0, self.plan.r1, self.plan.np_dtype
        bb = len(batch_slots)
        specs = any(it is not None and isinstance(it[1], RandomKtensorSpec) for it in batch_slots)
        explicit = not specs or any(it is not None and not isinstance(it[1], RandomKtensorSpec) for it in batch_slots)
        parts = [np.zeros((bb, m, r), np_dtype) for m in plan.block] + [np.zeros((bb, r), np_dtype)] if explicit else []
        xnm = np.full((bb,), self.call.x_norm_f, np_dtype)
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
                xnm[slot] = float(self.call.x_norms_jk[jk])
        flat = np.concatenate([p.reshape(-1) for p in parts] + [xnm])
        meta = np.concatenate([jk_arr, alive, spec, rank_mask.reshape(-1)])
        raw = self.worker.uploader.upload(np.concatenate([flat.view(np.uint8), meta.view(np.uint8)]))
        pieces = torch.split(raw[: flat.nbytes].view(plan.t_dtype), [p.size for p in parts] + [bb])
        jk_d, alive_d, spec_d, mask_d = torch.split(raw[flat.nbytes :].view(torch.int32), [bb, bb, bb, bb * r])
        mask_d = mask_d.view(bb, r).bool()
        if explicit:
            kt_b = Ktensor(tuple(pc.view(bb, m, r) for pc, m in zip(pieces, plan.block)),
                           pieces[len(plan.modes)].view(bb, r))
        if specs:
            gen = self.ahead.block(batch_slots)
            gen = gen._replace(factors=(gen.factors[0][:, r0:r1],) + tuple(gen.factors[1:]))
            kt_b = tree_where(spec_d.bool(), gen, kt_b) if explicit else gen
        # Pre-zero each jackknife slot's left-out row (the solver re-zeroes
        # it after every mode-0 update), where this rank holds it.
        kt_b = kt_b._replace(factors=(scale_jk_rows(kt_b.factors[0], jk_d - r0, 0.0),) + tuple(kt_b.factors[1:]))
        return init_state(
            kt_b, self.call.x_norm, jk_fiber=jk_d, x_norm_model=pieces[-1],
            rank_mask=mask_d, alive=alive_d.bool(), nnls=plan.nnls,
            line_search=plan.params.line_search, mixed_tol=plan.mixed_tol, tp=plan.tp,
        )

    def solve(self) -> list[int]:
        """A run-until-evict: the loop's iterations (and their trace rows),
        then the polish. Returns the slots to evict."""
        t0 = time.perf_counter()
        stats, k = self.loop.advance(self.plan.params.evict_batch)
        first = self.engine_iters + 1
        self.engine_iters += k
        trace = self.call.trace
        if trace is not None:
            ranks = [m[1] for m in self.slot_meta if m is not None]
            for it, (n_live, n_cols, wall) in enumerate(self.loop.trace_rows(ranks, time.perf_counter() - t0),
                                                        first):
                trace.add(IterationRecord(
                    iteration=it, active_models=int(n_live), active_columns=int(n_cols),
                    flops=int(self.flops_per_col * int(n_cols)), wall_s=wall, bucket=self.r))
        evicted = [s for s in range(self.b) if self.slot_meta[s] is not None and stats[0][s] != 0]
        if evicted:
            self.loop.polish()  # the end of the run-until-evict, as in the JAX program
        return evicted

    def evict(self, evicted: list[int]) -> None:
        """An eviction round: the evicted models stored, their slots refilled
        from the queue (one build for all) or vacated, then compaction."""
        keep = np.ones(self.b, bool)
        if evicted:
            with self.tot.span("evict.store"):
                self.store(evicted)
                refills = [(s, self.dq.popleft()) for s in evicted if self.dq]
                for s, (i, kt, jk) in refills:
                    self.slot_meta[s] = (i, kt.rank, jk)
                keep[evicted[len(refills):]] = False
            if refills:
                with self.tot.span("evict.refill"):
                    # This rank's slots' rows only, written into their slots.
                    slots = np.asarray([s for s, _ in refills])
                    mine = [it for (_, it), m in zip(refills, self.loop.shard.local(slots)) if m]
                    self.loop.refill(slots, self.block_state(mine) if mine else None)
        if not keep.all():
            with self.tot.span("evict.kill"):
                self.loop.kill(keep)
        self.compact()

    def store(self, evicted: list[int]) -> None:
        """The evicted models' stats, lam and factors in packed columns
        (``_evict_col_indices``) by one fetch, into the results, reports and
        records; their slots are vacant after. On a mesh each rank fetches
        the columns of its own slots (the rest read slot 0 and are zeroed)
        and its rows of factor 0, which one host all-reduce sums."""
        plan, loop, shard = self.plan, self.loop, self.loop.shard
        self.tot.count("fetches.evict")
        slot_idx, col_idx, offs = _evict_col_indices(evicted, self.slot_meta)
        mine = shard.local(slot_idx)
        idx = loop.uploader.upload(np.stack([np.where(mine, slot_idx - shard.lo, 0), col_idx]))
        flat, layout = _evicted_payload(loop.state, idx, plan.params.result_wire_dtype)
        stats, lam, *factors = _split_payload(loop.fetcher.fetch(flat, "evict"), layout)
        if not shard.trivial:
            cols = mine & shard.lead
            whole = [shard.gather_slots(stats, axis=1), np.where(cols, lam, 0).astype(lam.dtype)]
            for n, f in enumerate(factors):
                if n == 0:
                    f0 = np.zeros((f.shape[0], plan.modes[0]), f.dtype)
                    f0[mine & shard.rows_lead, plan.r0 : plan.r1] = f[mine & shard.rows_lead]
                    whole.append(f0)
                else:
                    whole.append(np.where(cols[:, None], f, 0).astype(f.dtype))
            stats, lam, *factors = shard.assemble(whole)
        factors = [f.astype(plan.np_dtype, copy=False) for f in factors]
        lam = lam.astype(plan.np_dtype, copy=False)
        for slot in evicted:
            i, rank, _ = self.slot_meta[slot]
            cols = slice(offs[slot], offs[slot] + rank)
            self.call.results[i] = Ktensor(tuple(np.ascontiguousarray(f[cols].T) for f in factors), lam[cols].copy())
            rep = CalsModelReport(id=i, rank=rank, iters=int(stats[1][slot]), fit=float(stats[2][slot]),
                                  approx_error=float(stats[3][slot]))
            self.models.append(rep)
            self.done_meta.append([i, rank, rep.iters, rep.fit, rep.approx_error])
            self.slot_meta[slot] = None

    def compact(self) -> None:
        """Tail compaction: once the queue is drained and at most half the
        slots are live, live slots repack into a half-size batch."""
        n_live = sum(m is not None for m in self.slot_meta)
        while (not self.dq and self.b > 1 and n_live <= self.b // 2
               and self.n_compactions < self.plan.params.tail_compaction_depth):
            with self.tot.span("evict.compact"):
                live_idx = [s for s in range(self.b) if self.slot_meta[s] is not None]
                pad_idx = [s for s in range(self.b) if self.slot_meta[s] is None]
                idx = live_idx + pad_idx[: self.b // 2 - len(live_idx)]
                self.loop = self.loop.compacted(idx)
                self.slot_meta = [self.slot_meta[s] for s in idx]
                self.b //= 2
                self.n_compactions += 1

    def checkpoint(self) -> None:
        """The bucket's snapshot, after the round's refill, kill and
        compaction (the state and ``slot_meta`` describe the same slots). On
        a mesh every rank joins the state's gather; the coordinator writes."""
        self.tot.count("checkpoints")
        leaves = self.loop.shard.gather_state(self.loop.state)
        if is_coordinator():
            self.snapshot.save(self.loop.state, self.slot_meta, self.done_meta, self.call.results, leaves)

    def report(self, report: CalsReport) -> None:
        """The bucket's models, engine iterations, phase times and loop
        counts (from its ``timers.Totals``) into ``report``."""
        tot, r = self.tot, self.r
        report.models.extend(self.models)
        report.engine_iterations[r] = report.engine_iterations.get(r, 0) + self.engine_iters
        capture = tot.seconds("loop.capture")
        report.phase_times[r] = {"setup": tot.seconds("bucket.intake"), "solve": tot.seconds("bucket.solve") - capture,
                                 "evict": tot.seconds("evict.round"), "capture": capture}
        if "bucket.checkpoint" in tot:
            report.phase_times[r]["checkpoint"] = tot.seconds("bucket.checkpoint")
        report.loop_counts[r] = dict(
            captures=tot.get("captures", 0), graph_reuses=tot.get("graphs.reused", 0), replays=tot.get("replays", 0),
            stats_fetches=sum(tot.get(f"fetches.{k}", 0) for k in ("chunk", "polish", "evict")),
            polish_sweeps=tot.get("polish_sweeps", 0), checkpoints=tot.get("checkpoints", 0),
            spec_builds=self.ahead.builds)


def _run_bucket(plan: _Plan, call: _Call, workers: queue_mod.SimpleQueue, threaded: bool, item: tuple) -> _Bucket:
    """The bucket of ``item`` (rank, queue, batch) run with a free worker,
    in its ``engine.bucket`` span; ``threaded``: in a bucket thread, whose
    counts then join the threads' common part (it ends with its executor)."""
    worker = workers.get()
    try:
        with timers.span("engine.bucket", item[0]):
            if plan.dev.type != "cuda":
                return _Bucket(plan, call, worker, *item).run()
            with torch.cuda.device(plan.dev), torch.cuda.stream(worker.stream):
                return _Bucket(plan, call, worker, *item).run()
    finally:
        workers.put(worker)
        if threaded:
            launches.retire_thread()


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
    if x.ndim < 3:
        raise ValueError(f"CP-CALS needs a tensor of >= 3 modes, got shape {tuple(x.shape)}")
    _check_queue(queue, tuple(x.shape))
    plan = _Plan(x, queue, params, jk_fibers, dev, mesh, shard_mode0)
    report = CalsReport(n_ktensors=len(queue), ktensor_comp_sum=sum(kt.rank for kt in queue))
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    # One worker per bucket thread (``_Worker``), each lent to one bucket at
    # a time, so a running bucket has its stream, graphs and pinned buffers
    # to itself. This call's stream first waits on the streams (the last
    # call's work on them), then makes x, the norms and the held layouts,
    # or writes them into the kept ones; the streams wait on it, and it
    # waits on them before the call returns. No record_stream is needed:
    # what the call's stream allocated lives until the call returns, after
    # that wait, or is kept with the graphs, and a bucket frees only what
    # its own stream allocated, which only later work of that stream can
    # reuse.
    most = 1 if mesh is not None else max(1, min(params.bucket_threads, max(len(w) for w in plan.waves)))
    with _bucket_streams(dev, most) as (streams, cache):
        if dev.type == "cuda":
            call_stream = torch.cuda.current_stream(dev)
            for s in streams:
                call_stream.wait_stream(s)
        # Captured where the device keeps graphs (the card), but not a debug
        # run, which reads the device on the host in every iteration, nor an
        # iteration that sums over a tp group (its collectives).
        captured = plan.chunked and cache is not None and not params.debug and plan.tp is None
        if captured:
            cache.admit((torch.Size(plan.block), plan.t_dtype, str(dev), plan.policy, params, plan.has_jk,
                         trace is not None, tuple(map(id, launches.TALLIES))))
        src = x
        x = x[plan.r0 : plan.r1].to(device=dev, dtype=plan.t_dtype).contiguous()
        with timers.span("engine.norms"):
            x_norm, loo = _norms(x, plan.has_jk and x_norms_jk is None, plan.tp)
            x_norm_f = float(x_norm)
        # The loop-invariant layouts of X, (mode, method, tier) -> tensor,
        # shared by every bucket (module docstring); none under
        # mode_layouts="recompute".
        layouts: dict = {}
        if captured:
            owned = x.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()
            x, x_norm, layouts = cache.inputs(x, x_norm, owned)
        call = _Call(x, x_norm, x_norm_f, loo if x_norms_jk is None else _to_numpy(x_norms_jk), layouts, {},
                     trace, checkpoint_dir, resume, max_rounds_per_bucket)
        # Every bucket's methods (autotuned on a miss) before any bucket
        # runs, in this thread: no autotune times against a running bucket.
        with timers.span("engine.programs"):
            for r, b in plan.buckets:
                plan.program(plan.methods(r, b), x, layouts)
        workers: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        graphs = cache.graphs(len(streams)) if captured else [None] * len(streams)
        for s, g in zip(streams, graphs):
            workers.put(_Worker(s, g, Pinned(dev), Pinned(dev)))
        if dev.type == "cuda":
            for s in streams:
                s.wait_stream(call_stream)
        for wave in plan.waves:
            # Largest-work-first order, as in the JAX engine: the widest
            # bucket starts first.
            items = sorted(((r, plan.queues[r], b) for r, b in wave.items()), key=lambda t: (-t[0] * t[2], t[0]))
            n_threads = min(most, len(items))
            if n_threads > 1:
                with concurrent.futures.ThreadPoolExecutor(n_threads, "cals-bucket") as ex:
                    done = list(ex.map(functools.partial(_run_bucket, plan, call, workers, True), items))
            else:
                done = [_run_bucket(plan, call, workers, False, item) for item in items]
            for bucket in done:
                bucket.report(report)
        if dev.type == "cuda":
            for s in streams:
                call_stream.wait_stream(s)

    with timers.span("engine.results"):
        report.models.sort(key=lambda m: m.id)
        # Unfinished models (max_rounds_per_bucket) are None.
        out = [call.results.get(i) for i in range(len(queue))]
    return out, report
