"""The engine's two bucket loops (``sync_mode``): the device-paced
run-until-evict loop, and the per-iteration host loop.

``ChunkLoop`` (``sync_mode="evict"``) is the port of the JAX engine's
device while-loop (``cp_cals_tpu/solvers/cals.py:630-707``,
``make_run_until_evict``) with the polish sweeps that program carries
(``:138-211``). The bucket's ``SolverState`` lives in buffers that stay in
place for the whole bucket; the host runs the loop in chunks of iterations
and reads the packed eviction stats once per chunk, with one copy into
pinned memory. On the card one iteration (the iteration, the freeze
select, the copy back into the buffers, the packed stats) is captured once
per (bucket rank, batch) into a CUDA graph, after one eager iteration has
filled every cache the kernel wrappers keep (built libraries,
shared-memory attributes, launch plans) and the thread's cuBLAS workspace
for the stream, and a chunk of n iterations is n replays. Both run on the
bucket's own stream, in the bucket's thread (``Graphs``). Capture has no
fallback: a failure raises. On the CPU the same loop runs eagerly.

Chunk length (``chunk_length``), from the slots' iteration counts, which
the host knows from the last fetch:
- with ``force_max_iter``: exactly up to the first forced convergence, so
  the loop runs no iteration past it;
- with ``tol_check_interval = K``: up to the oldest live model's next
  check, its pre-check mK-1 or its decision check mK (a model can stop
  only at a check or at ``max_iterations``; the JAX loop evicts at either
  check, so a chunk that ran on past a pre-check would refill a slot an
  iteration late). Under NO_ERROR_CHECKING line search a revert puts back
  the count of the extrapolation's iteration, so a count stands still for
  an iteration, never more: where the oldest count is at a check, the next
  chunk is one iteration, since it may check again at that count;
- with a per-iteration tol: ``TOL_CHUNK`` iterations;
- never past the first slot's ``max_iterations``;
- under ``debug``, one iteration (the JAX loop's iterations exactly, so the
  debug hook records what JAX's records).
Apart from that count, line search needs nothing of the chunks: a
NO_ERROR_CHECKING model whose extrapolation is pending does not converge
before its check (its fit difference is BIG_ERROR's, and the mixed-tier
check skips it).
Models that converge inside a chunk are frozen by a select (as the JAX
loop freezes them under ``evict_batch > 1``), so a chunk only delays the
eviction. Under ``force_max_iter`` with ``evict_batch = 1`` no chunk runs
past a convergence, so
evictions, refills and compactions come at the per-iteration loop's
iterations and every model's bits are that loop's (the bench's forced runs
on the card). Otherwise the delay moves refills to other slots and tail
compaction to other iterations, and a model keeps the bits of immediate
eviction only where the MTTKRP gives it the same bits in any slot and
batch (on the CPU, a product per model: the tests). Where it does not, as
in the jackknife's tol-driven runs with compaction on the card, the last
bits differ, and through them a stop may move.

Polish (``polish_iters``) runs where the JAX program runs it: once at the
end of each run-until-evict, on the converged live models, before the
eviction stats are read. Each sweep is one more iteration at full
``precision`` (no mixed-tier check) with the models outside the polish
frozen; on the card one sweep is captured as its own graph. With
``polish_tol > 0`` a model also freezes at its own fixed point, and the
host reads whether all have every ``POLISH_CHECK`` sweeps, never running
more than ``polish_iters``.

Graphs bake in pointers: ``x``, the held layouts (the dimension tree's
shared-TTM layout in their last slot), the state buffers and the stats
buffer stay alive and in place while a graph is replayed. Under
``mode_layouts="recompute"`` nothing is held: each captured MTTKRP derives
its layout from ``x`` inside the graph, in the graph's memory pool, where
each copy is freed after its mode, so a replay needs about one layout
beside X.
Refills and evictions write into the buffers; tail compaction (a new
batch) makes a new loop, with buffers and graphs of its own. The kernel
wrappers count their launches in Python, which a replay does not run: each
replay adds the counts its graph's capture added (``Graph``,
``launches.py``), and so the layouts its iteration derives
(``ops/mttkrp.LAYOUTS``) to the recorder's ``layouts.derived`` and
``layouts.derived_bytes``, and its tensor-core MTTKRP launches whose j
splits fill more than one wave (``ops/fused_mttkrp.BALANCED``) to
``mttkrp.tc_balanced``.

Graphs outlive the engine call that captured them. A bucket stream's
``Graphs`` keeps, by loop key (the bucket's rank and batch and its MTTKRP
methods and polish methods), every buffer a loop's graphs read or write
(``LoopBuffers``) and the graphs themselves; the engine keeps X, |X| and
the held layouts beside them and releases the whole set when a call's key
(shapes, dtype, params, tracing, ...) differs (``cals.GraphCache``). A
loop whose key is kept writes its state into the kept buffers and
replays, with no eager first call and no capture; a loop whose key is not
kept captures as above and keeps what it made.

Tracing (``cp_cals(trace=...)``): each captured iteration first writes
(live models, live true-rank columns), "live" meaning alive and not
converged, into row k of a ``[max_iterations, 2]`` int32 buffer at a
device-side counter k, which the host zeroes before each chunk. The
buffer sits behind the stats in one byte buffer, so the chunk's one stats
fetch brings it back (``trace_chunks``: one (rows, wall per iteration)
per chunk). This is the JAX loop's ``trace_cap`` buffer
(``cp_cals_tpu/solvers/cals.py:make_run_until_evict``). Each loop hands
the engine its rows (``trace_rows``): the chunk loop these, the
per-iteration loop one row a round from the occupied slots the engine
hands it, as the JAX engine's host records.

Spans and counts (``utils/timers.py``), in the bucket's ``timers.Totals``:
``loop.chunk`` (a chunk's replays or eager iterations), ``loop.capture``
(the eager first call and the capture of a step or sweep graph, inside
its chunk or polish), ``loop.polish`` and, per fetch, ``loop.fetch``
(the host blocked in ``Pinned.fetch`` or in the polish's read, tagged
with its kind); the counts ``fetches.chunk``, ``fetches.polish`` (the
engine counts ``fetches.evict``), ``captures``, ``graphs.reused`` (one
per kept graph a loop takes), ``replays`` and ``polish_sweeps``.
``Pinned`` counts ``uploads``, ``upload_bytes`` and ``fetch_bytes`` while
the recorder is on.

``IterLoop`` (``sync_mode="iter"``, and ``always_evict_first``) is the JAX
engine's per-iteration mode: one eager iteration, then the host reads the
stats, evicts and refills. It freezes nothing and does not polish, as the
JAX step program does not. Under ``always_evict_first`` its stats mark the
leftmost occupied slot, and it alone, as converged every round (the
reference's defrag stress); the engine's round does not know the knob.

On a mesh (``parallel.sharding.Shard``) a loop holds this rank's slots of
the bucket and the host's view of every slot: each stats fetch (and the
trace rows behind it, and the polish's done flags) is gathered from every
rank by one host all-reduce, so every rank takes the same chunk lengths,
evictions, refills, kills and compactions. Refills write the rank's own
slots; tail compaction gathers the bucket's state where dp splits it and
takes the new batch's share. The engine runs a loop whose iteration sums
over a tp group uncaptured (``graphs`` None).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import launches
from ..config import LineSearchMethod
from ..ops.fused_mttkrp import BALANCED
from ..ops.mttkrp import LAYOUTS
from ..parallel.sharding import Shard
from ..utils import timers
from .state import SolverState, tree_leaves, tree_map

# The launch counts a replay also adds to the recorder, by tally: the
# recorder's name is the prefix and the key.
RECORDED = ((LAYOUTS, "layouts."), (BALANCED, "mttkrp."))
TOL_CHUNK = 4  # iterations per chunk under a per-iteration tol
POLISH_CHECK = 4  # polish sweeps between host reads of the polish's done flags


def pack_evict_stats(state: SolverState) -> torch.Tensor:
    """Everything the host eviction scan reads, in ONE tensor (one fetch).
    Rows: converged & alive, iters, fit, approx_error, alive & unconverged."""
    dt = torch.promote_types(state.fit.dtype, torch.float32)
    return torch.stack(
        [
            (state.converged & state.alive).to(dt),
            state.iters.to(dt),
            state.fit.to(dt),
            state.approx_error.to(dt),
            (state.alive & ~state.converged).to(dt),
        ]
    )


def chunk_length(params, iters: np.ndarray, live: np.ndarray) -> int:
    """Iterations of the next chunk (module docstring); ``iters`` and
    ``live`` per slot, with at least one live slot."""
    if params.debug:  # one iteration per chunk: JAX's loop, iteration by iteration
        return 1
    it = iters[live]
    n = int((params.max_iterations - it).min())
    if params.force_max_iter:
        return max(n, 1)
    k = params.tol_check_interval
    if k > 0:  # to the next iteration whose phase is K-1 or 0
        top = int(it.max())
        # A NO_ERROR_CHECKING revert puts back the count of the
        # extrapolation's iteration: from a check, the next may check again.
        nec = params.line_search and params.line_search_method == LineSearchMethod.NO_ERROR_CHECKING
        if nec and top % k in (0, k - 1):
            step = 1
        else:
            step = next(s for s in range(1, k + 1) if (top + s) % k in (0, k - 1))
    else:
        step = TOL_CHUNK
    return max(min(n, step), 1)


class Graph:
    """``fn`` captured once into a CUDA graph on the current stream (not
    the default stream), and what one replay adds to the launch counts
    (``launches.py``: what the capture, which launches nothing, added in
    this thread; the counts are put back), of which the derived layouts
    and the tensor-core launches over several waves (``RECORDED``) also go
    to the recorder at each replay. ``pool`` is a memory pool the graph may
    share with others that are never replayed at once and keep nothing
    between replays in it.

    The capture runs in ``thread_local`` error mode: the engine's other
    bucket threads go on fetching, synchronising and allocating while it
    is open, which the default global mode forbids to every thread of the
    process (the capture would fail). Calls of this thread that a capture
    forbids still fail it. The caching allocator gives the pool only the
    allocations made on the capturing stream."""

    def __init__(self, fn, pool=None):
        before = launches.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            self.graph.capture_end()
        self.per_replay = launches.take_added(before)
        self.recorded = [(prefix + key, d) for t, key, d in self.per_replay
                         for tally, prefix in RECORDED if t is tally]

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        launches.add(self.per_replay, n)
        for name, d in self.recorded:
            timers.count(name, n * d)


class Graphs:
    """The CUDA graphs of one bucket stream, kept from one engine call to
    the next with every buffer they read or write (``loops``: loop key ->
    ``LoopBuffers``; module docstring), in one memory pool: a graph's pool
    holds only the temporaries of one replay, and no two graphs of a
    stream are replayed at once (the buckets of a stream run one after
    another, and an engine call holds the device's streams until its
    buckets end), while another stream's replay may run at the same time
    (so each stream has its pool). The warm-up and the capture run on the
    stream, in the bucket's thread: PyTorch keeps a cuBLAS handle per
    thread and its workspace per stream, which the warm-up sets up outside
    the capture, and a graph replays on the stream it was captured on, so
    it keeps that workspace."""

    def __init__(self):
        self.pool = None  # made at the first capture
        self.loops: dict = {}

    def capture(self, fn) -> Graph:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return Graph(fn, self.pool)


class LoopBuffers:
    """Every buffer a chunk loop's graphs read or write, and its step and
    sweep graphs (None until captured): the bucket's state, the stats with
    the trace rows behind them in one byte buffer (one fetch a chunk; no
    rows untraced), the trace rows' counter, and the polish's flags."""

    def __init__(self, state: SolverState, params, traced: bool, polish: bool):
        self.state = tree_map(lambda t: t.clone(), state)
        dev = state.iters.device
        stats = pack_evict_stats(self.state)
        ns = stats.numel() * stats.element_size()
        cap = max(params.max_iterations, 1) if traced else 0
        self.fetch_buf = torch.zeros(ns + 8 * cap, dtype=torch.uint8, device=dev)
        self.stats = self.fetch_buf[:ns].view(stats.dtype).view(stats.shape)
        self.trace_buf = self.fetch_buf[ns:].view(torch.int32).view(cap, 2)
        self.trace_k = torch.zeros(1, dtype=torch.int64, device=dev)
        self.done = self.conv0 = self.iters0 = None
        if polish:
            self.done = torch.zeros(state.iters.shape[0], dtype=torch.bool, device=dev)
            self.conv0 = torch.zeros_like(self.done)
            self.iters0 = torch.zeros_like(state.iters)
        self.step_graph = self.sweep_graph = None


# ------------------------------------------------------------ host transfers


class Pinned:
    """A pinned host buffer for one direction of transfer. A fetch waits on
    its copy's event; an upload first waits until the buffer's last copy
    has finished, so the buffer is never written while a copy reads it. On
    the CPU both are plain copies."""

    def __init__(self, device: torch.device):
        self.device, self.buf, self.event = device, None, None

    def _host(self, n: int) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        if self.buf is None or self.buf.numel() < n:  # grown geometrically: pinning is slow
            size = max(n, 2 * (self.buf.numel() if self.buf is not None else 0), 1 << 20)
            self.buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        return self.buf[:n]

    def fetch(self, t: torch.Tensor, kind: str | None = None) -> np.ndarray:
        """A host copy of the contiguous device tensor ``t``; ``kind`` tags
        the span of the host's wait (the engine's: ``chunk``, ``evict``)."""
        timers.count("fetch_bytes", t.numel() * t.element_size())
        if self.device.type != "cuda":
            with timers.span("loop.fetch", kind):
                return t.numpy().copy()
        raw = t.reshape(-1).view(torch.uint8)
        host = self._host(raw.numel())
        host.copy_(raw, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        with timers.span("loop.fetch", kind):
            self.event.synchronize()
            return host.numpy().view(NP_DTYPES[t.dtype]).reshape(t.shape).copy()

    def upload(self, data: np.ndarray) -> torch.Tensor:
        """``data`` (contiguous) on the device, copied without blocking."""
        timers.count("uploads")
        timers.count("upload_bytes", data.nbytes)
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(data))
        raw = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        host = self._host(raw.size)
        host.numpy()[:] = raw
        out = torch.empty(raw.size, dtype=torch.uint8, device=self.device)
        out.copy_(host, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return out.view(_TORCH_DTYPES[data.dtype]).reshape(data.shape)


# The host dtype of each device dtype that crosses (bfloat16 as its bits).
NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
             torch.bfloat16: np.uint16}
_TORCH_DTYPES = {np.dtype(v): k for k, v in NP_DTYPES.items() if k != torch.bfloat16}


# ------------------------------------------------------------ the two loops


def _assign(dst_state, src_state, frozen: torch.Tensor | None = None) -> None:
    """Write ``src_state`` into ``dst_state``'s buffers in place, leaf by
    leaf, keeping the old value of every slot where ``frozen``; leaves that
    are the same tensor are left alone."""
    for dst, src in zip(tree_leaves(dst_state), tree_leaves(src_state)):
        if src is dst:
            continue
        if frozen is None:
            dst.copy_(src)
        else:  # the select writes the buffer itself: one kernel per leaf
            torch.where(frozen.reshape(frozen.shape + (1,) * (dst.ndim - 1)), dst, src, out=dst)


class _Loop:
    """What both loops share: the bucket's state, the host's view of each
    slot's iteration count and liveness, refills, kills and compaction,
    and the counts the engine reports. ``uploader`` and ``fetcher`` carry
    the host's transfers each way (``Pinned``); ``totals`` (the bucket's
    ``timers.Totals``) takes the loop's spans and counts. ``shard`` places
    the bucket on a mesh (None: one process holds every slot); ``state``
    holds this rank's slots, ``iters_h`` and ``live_h`` every slot."""

    def __init__(self, state: SolverState, iters_h: np.ndarray, live_h: np.ndarray, totals: timers.Totals,
                 uploader: Pinned, fetcher: Pinned, shard: Shard | None = None):
        self.state = state
        self.iters_h, self.live_h = iters_h, live_h
        self.totals, self.uploader, self.fetcher = totals, uploader, fetcher
        self.device = state.iters.device
        i0 = state.kt.factors[0].shape[1]
        self.shard = shard if shard is not None else Shard(None, len(iters_h), (0, i0, i0))

    def refill(self, slots: np.ndarray, fresh: SolverState | None) -> None:
        """Slots ``slots`` take fresh models: ``fresh`` holds one row each
        for those of them this rank holds, in order (None where it holds
        none)."""
        if fresh is not None:
            mine = slots[self.shard.local(slots)] - self.shard.lo
            self._write_rows(self.uploader.upload(mine.astype(np.int64)), fresh)
        self.iters_h[slots] = 0
        self.live_h[slots] = True

    def kill(self, keep: np.ndarray) -> None:
        """Slots outside ``keep`` are vacant from now on."""
        keep_d = self.uploader.upload(keep[self.shard.lo : self.shard.hi].astype(np.uint8)).bool()
        self._write_rows(None, self.state._replace(alive=self.state.alive & keep_d))
        self.live_h &= keep

    def fetch_stats(self, buf: torch.Tensor, stats: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """One fetch of ``buf``, a byte buffer that begins with ``stats``:
        the host's stats [5, B] of every slot (their iteration counts and
        liveness become the host's view) and the bytes behind them (on a
        mesh summed over the slots' leads)."""
        self.totals.count("fetches.chunk")
        raw = self.fetcher.fetch(buf, "chunk")
        ns = stats.numel() * stats.element_size()
        out = raw[:ns].view(NP_DTYPES[stats.dtype]).reshape(stats.shape)
        rest = raw[ns:]
        if not self.shard.trivial:
            out, rest = self.shard.assemble([self.shard.gather_slots(out, axis=1),
                                             rest if self.shard.lead else np.zeros_like(rest)])
        self.iters_h = out[1].astype(np.int64)
        self.live_h = out[4] != 0
        return out, rest

    def all_set(self, flags: torch.Tensor) -> bool:
        """Whether a per-slot bool tensor is set in every slot of the bucket
        (one host read, gathered on a mesh)."""
        with timers.span("loop.fetch", "polish"):
            unset = np.array([int((~flags).sum()) if self.shard.lead else 0], np.int64)
        return int(self.shard.assemble([unset])[0][0]) == 0

    def polish(self) -> None:
        """The end of a run-until-evict: no polish in this loop."""

    def _compacted_state(self, idx: list[int]) -> tuple[SolverState, Shard]:
        """This rank's part of the bucket's slots ``idx`` (a half-size
        batch), and the batch's shard."""
        new = self.shard.resized(len(idx))
        idx_t = torch.as_tensor(idx, device=self.device)
        return new.take(tree_map(lambda leaf: leaf[idx_t], self.shard.whole_state(self.state))), new


class IterLoop(_Loop):
    """One eager iteration per host round (``sync_mode="iter"``). With
    ``evict_first`` (``always_evict_first``, the reference's defrag-stress
    knob, cals.cpp:346-352) each round's stats mark the leftmost occupied
    slot, and it alone, as converged, whether it converged or not."""

    def __init__(self, iteration, x, x_norm, prepared, state, iters_h, live_h, totals, uploader, fetcher,
                 shard=None, evict_first: bool = False):
        super().__init__(state, iters_h, live_h, totals, uploader, fetcher, shard)
        self.iteration, self.x, self.x_norm, self.prepared = iteration, x, x_norm, prepared
        self.evict_first = evict_first

    def _write_rows(self, rows, new):
        self.state = new if rows is None else tree_map(
            lambda old, fresh: old.index_copy(0, rows, fresh), self.state, new)

    def advance(self, evict_batch: int) -> tuple[np.ndarray, int]:
        """One iteration."""
        with self.totals.span("loop.chunk"):
            self.state = self.iteration(self.x, self.state, self.x_norm, self.prepared)
            stats = pack_evict_stats(self.state)
        stats = self.fetch_stats(stats.reshape(-1).view(torch.uint8), stats)[0]
        if self.evict_first:  # occupied: alive, converged (row 0) or not (row 4)
            first = int(np.argmax((stats[0] != 0) | (stats[4] != 0)))
            stats[0] = 0
            stats[0][first] = 1
        return stats, 1

    def trace_rows(self, ranks: list, wall: float) -> list:
        """The round's one row: the occupied slots the host hands in (their
        models' ranks) and the round's wall."""
        return [(len(ranks), sum(ranks), wall)]

    def compacted(self, idx: list[int]) -> "IterLoop":
        state, shard = self._compacted_state(idx)
        return IterLoop(self.iteration, self.x, self.x_norm, self.prepared, state, self.iters_h[idx],
                        self.live_h[idx], self.totals, self.uploader, self.fetcher, shard, self.evict_first)


class ChunkLoop(_Loop):
    """Run-until-evict in chunks (module docstring); on the card (``graphs``
    given) each chunk is replays of one captured iteration, the buffers and
    graphs kept in ``graphs`` by the loop's key. ``polish`` is None, or (the
    polish iteration, its held layouts, polish_iters, polish_tol)."""

    def __init__(self, iteration, x, x_norm, prepared, state, iters_h, live_h, totals, uploader,
                 fetcher, params, polish=None, graphs: Graphs | None = None, traced: bool = False,
                 shard=None):
        key = (tuple(state.kt.lam.shape), prepared.methods, polish[1].methods if polish is not None else None)
        buf = graphs.loops.get(key) if graphs is not None else None
        if buf is None:
            buf = LoopBuffers(state, params, traced, polish is not None)
            if graphs is not None:
                graphs.loops[key] = buf
        else:  # this call's state into the kept buffers
            _assign(buf.state, state)
        if graphs is not None:  # the kept graphs this loop takes (0 where it captures its own)
            totals.count("graphs.reused", (buf.step_graph is not None) + (buf.sweep_graph is not None))
        buf.stats.copy_(pack_evict_stats(buf.state))
        super().__init__(buf.state, iters_h, live_h, totals, uploader, fetcher, shard)
        self.iteration, self.x, self.x_norm, self.prepared = iteration, x, x_norm, prepared
        self.params, self.polish_cfg, self.graphs, self.buf = params, polish, graphs, buf
        self.traced, self.trace_chunks = traced, []

    def _write_rows(self, rows, new):
        if rows is None:
            _assign(self.state, new)
            return
        for dst, src in zip(tree_leaves(self.state), tree_leaves(new)):
            dst.index_copy_(0, rows, src)

    def _step(self) -> None:
        st, buf = self.state, self.buf
        if self.traced:
            live = st.alive & ~st.converged
            row = torch.stack([live.sum(), (st.rank_mask & live[:, None]).sum()]).to(torch.int32)
            buf.trace_buf.index_copy_(0, buf.trace_k, row[None])
            buf.trace_k.add_(1)
        frozen = st.converged & st.alive
        _assign(st, self.iteration(self.x, st, self.x_norm, self.prepared), frozen)
        buf.stats.copy_(pack_evict_stats(st))

    def _sweep(self) -> None:
        st, done = self.state, self.buf.done
        p_iter, p_prepared, _, tol = self.polish_cfg
        new = p_iter(self.x, st, self.x_norm, p_prepared)
        if tol > 0:
            delta = torch.abs(new.fit - st.fit)
        _assign(st, new, done)
        if tol > 0:
            torch.logical_or(done, delta < tol, out=done)

    def _run(self, fn, graph_name: str, n: int) -> None:
        """``fn`` n times: eagerly on the CPU; on the card by replays of its
        graph (``graph_name`` of the loop's buffers), captured after a first
        eager call where no graph is kept (``Graphs``)."""
        if self.graphs is None:
            for _ in range(n):
                fn()
            return
        if getattr(self.buf, graph_name) is None:
            with self.totals.span("loop.capture"):
                fn()
                n -= 1
                setattr(self.buf, graph_name, self.graphs.capture(fn))
            self.totals.count("captures")
        getattr(self.buf, graph_name).replay(n)
        self.totals.count("replays", n)

    def advance(self, evict_batch: int) -> tuple[np.ndarray, int]:
        """Chunks until at least one live model has converged (or, with
        ``evict_batch > 1``, that many have or none is left unconverged).
        On entry no live model is converged. Returns (host stats [5, B],
        iterations run)."""
        total = 0
        while True:
            n = chunk_length(self.params, self.iters_h, self.live_h)
            t0 = time.perf_counter()
            with self.totals.span("loop.chunk"):
                if self.traced:
                    self.buf.trace_k.zero_()
                self._run(self._step, "step_graph", n)
            total += n
            stats, rows = self.fetch_stats(self.buf.fetch_buf, self.buf.stats)
            if self.traced:
                self.trace_chunks.append((rows.view(np.int32).reshape(-1, 2)[:n], (time.perf_counter() - t0) / n))
            n_conv = int(np.count_nonzero(stats[0]))
            if evict_batch <= 1:
                if n_conv:
                    return stats, total
            elif n_conv >= evict_batch or not np.count_nonzero(stats[4]):
                return stats, total

    def trace_rows(self, ranks: list, wall: float) -> list:
        """The rows of the chunks run since the last call: the device's
        counts, each chunk's wall shared by its iterations."""
        rows = [(*row, w) for chunk, w in self.trace_chunks for row in chunk]
        self.trace_chunks.clear()
        return rows

    def polish(self) -> None:
        """The polish sweeps on the converged live models (module
        docstring), their converged flags and iteration counts kept; none
        without a polish."""
        if self.polish_cfg is None:
            return
        with self.totals.span("loop.polish"):
            _, _, n_polish, tol = self.polish_cfg
            st, buf = self.state, self.buf
            buf.conv0.copy_(st.converged)
            buf.iters0.copy_(st.iters)
            torch.logical_not(st.converged & st.alive, out=buf.done)
            k = 0
            while k < n_polish:
                m = n_polish - k if tol <= 0 else min(1 if self.params.debug else POLISH_CHECK, n_polish - k)
                self._run(self._sweep, "sweep_graph", m)
                k += m
                self.totals.count("polish_sweeps", m)
                if tol > 0 and k < n_polish:
                    self.totals.count("fetches.polish")
                    if self.all_set(buf.done):
                        break
            st.converged.copy_(buf.conv0)
            st.iters.copy_(buf.iters0)
            buf.stats.copy_(pack_evict_stats(st))

    def compacted(self, idx: list[int]) -> "ChunkLoop":
        state, shard = self._compacted_state(idx)
        return ChunkLoop(self.iteration, self.x, self.x_norm, self.prepared, state,
                         self.iters_h[idx], self.live_h[idx], self.totals, self.uploader, self.fetcher,
                         self.params, self.polish_cfg, self.graphs, self.traced, shard)
