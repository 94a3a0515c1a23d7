"""Concurrent ALS (CALS) engine: many CP models of varying rank fitted in
one stream (port of ``cp_cals_tpu/solvers/cals.py`` for explicit host
Ktensor queues).

Models are padded to a rank bucket and packed into batched slots
``[B, I_n, R]``; one global padded-column budget (``buffer_size``) is split
across buckets (``allocate_bucket_batches``). Each bucket runs lock-step
ALS iterations until at least one live model converges, then the host
evicts converged models (one packed fetch of their true-rank columns, their
lam and the eviction stats), refills the vacated slots from the queue by a
masked select, and repeats. Padded columns and vacant slots are inert, so
concurrency is invisible to each model's trajectory.

The bucket loop is ``graph_loop.ChunkLoop`` by default (``sync_mode=
"evict"``): the run-until-evict loop in chunks of iterations, each chunk
replays of a CUDA graph on the card, one stats fetch per chunk, and the
polish sweeps at the end of each run-until-evict. ``sync_mode="iter"`` (and
``always_evict_first``) runs ``graph_loop.IterLoop``, one eager iteration
per host round, the JAX package's per-iteration mode and the eager
reference on the card. Refills upload through pinned memory without
blocking. A ``debug`` run takes the chunk loop eagerly, one iteration per
chunk, with no CUDA graph: its hook reads every iteration on the host.

Differences from the JAX engine (ROADMAP section 3): buckets run one after
another (``bucket_threads`` is accepted and not used); results are fetched
synchronously. Device-generated ``RandomKtensorSpec`` queues, meshes,
checkpoints and traces raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..config import CalsParams, UpdateMethod, check_supported, not_ported
from ..device import resolve_device
from ..ktensor import Ktensor, scale_jk_rows
from .graph_loop import NP_DTYPES, ChunkLoop, Graphs, IterLoop, Pinned, pack_evict_stats
from .iteration import make_iteration
from .state import SolverState, init_state


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
    materialize_s: float = 0.0
    # bucket rank -> the loop's counts: graph captures and replays, stats
    # fetches (one per chunk, per polish check, per eviction round), and
    # polish sweeps.
    loop_counts: dict = field(default_factory=dict)


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


def _norms(x: torch.Tensor, with_jk: bool):
    """(|X| on the device in x's dtype, leave-one-out norms per mode-0 fiber
    on the host or None). |X| reduces in float64: a float32 sum of squares
    over millions of entries on the CPU drifts by 1e-4 relative, which the
    FastALS error's |X|^2 - ... cancellation turns into a wrong fit. The
    leave-one-out norms are ``jackknife_norms``."""
    from .jackknife import jackknife_norms

    x_norm = torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64).to(x.dtype)
    if not with_jk:
        return x_norm, None
    return x_norm, jackknife_norms(x).cpu().numpy()


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _queue_dtype(queue) -> np.dtype:
    dt = _to_numpy(queue[0].lam).dtype
    if dt not in _DTYPES:
        raise ValueError(f"queue dtype {dt}: float32 or float64 expected")
    return dt


# ------------------------------------------------------------------ engine


def cp_cals(
    x,
    queue: Sequence[Ktensor],
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
    queue: Ktensors with NumPy or torch factors [I_n, R] and lam [R].
    jk_fibers: optional per-model jackknifed mode-0 fiber (-1 = regular
    model); leave-one-out norms are computed once unless ``x_norms_jk`` is
    given. device: None means the CUDA card (raises without one); pass
    "cpu" to run the plain PyTorch versions of the kernels.
    max_rounds_per_bucket: stop each bucket after this many eviction
    rounds; unfinished models are returned as None.
    """
    if mesh is not None or shard_mode0:
        raise not_ported("multi-device runs", "queue 1 item 10")
    if trace is not None:
        raise not_ported("trace", "queue 1 item 8")
    if checkpoint_dir is not None or resume:
        raise not_ported("checkpoint/resume", "queue 1 item 8")
    check_supported(params)
    dev = resolve_device(device)
    if not queue:
        return [], CalsReport()
    for i, kt in enumerate(queue):
        if not (hasattr(kt, "factors") and hasattr(kt, "lam")):
            raise not_ported(
                f"queue[{i}] ({type(kt).__name__}): device-generated specs",
                "queue 1 item 7",
            )
    np_dtype = _queue_dtype(queue)
    x = torch.as_tensor(x).to(device=dev, dtype=_DTYPES[np_dtype]).contiguous()
    if x.ndim < 3:
        raise ValueError(f"CP-CALS needs a tensor of >= 3 modes, got shape {tuple(x.shape)}")
    modes = tuple(x.shape)
    for i, kt in enumerate(queue):
        shapes = tuple(int(f.shape[0]) for f in kt.factors)
        if shapes != modes:
            raise ValueError(
                f"queue[{i}]: model factor leading dims {shapes} do not match "
                f"tensor shape {modes}"
            )
    if jk_fibers is None:
        jk_fibers = [-1] * len(queue)
    has_jk = any(f >= 0 for f in jk_fibers)
    x_norm, loo = _norms(x, has_jk and x_norms_jk is None)
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
    iteration = make_iteration(params, batched=True, has_jk=has_jk)
    prepared = iteration.prepare(x)  # loop-invariant layouts, once per solve
    polish = None
    if chunked and params.polish_iters > 0:
        # The polish sweeps: full `precision`, no line search, no mixed-tier
        # check (polish keeps converged and iters), on X held at that tier.
        p_params = dataclasses.replace(
            params, mttkrp_precision=None, line_search=False, tol_check_interval=0
        )
        p_iter = make_iteration(p_params, batched=True, has_jk=has_jk)
        polish = (p_iter, prepared.hi, params.polish_iters, params.polish_tol)
    results: dict[int, Ktensor] = {}
    mixed_tol = params.tol_check_interval > 0
    nnls = params.update_method == UpdateMethod.NNLS

    def build_block_state(uploader: Pinned, batch_slots, r: int) -> SolverState:
        """A state of one row per intake item ((id, ktensor, jk), or None
        for a dead slot): one upload through pinned memory (the factors,
        lam and norms, then the int32 jackknife fibers, alive flags and
        rank mask), then the gramians of the initial guesses on the
        device."""
        bb = len(batch_slots)
        parts = [np.zeros((bb, m, r), np_dtype) for m in modes]
        lam = np.zeros((bb, r), np_dtype)
        xnm = np.full((bb,), x_norm_f, np_dtype)
        jk_arr = np.full((bb,), -1, np.int32)
        alive = np.zeros((bb,), np.int32)
        rank_mask = np.zeros((bb, r), np.int32)
        for slot, item in enumerate(batch_slots):
            if item is None:
                continue
            _, kt, jk = item
            rk = kt.rank
            for dst, src in zip(parts, kt.factors):
                dst[slot, :, :rk] = _to_numpy(src)
            lam[slot, :rk] = _to_numpy(kt.lam)
            alive[slot] = 1
            rank_mask[slot, :rk] = 1
            jk_arr[slot] = jk
            if jk >= 0:
                xnm[slot] = float(x_norms_jk[jk])
        flat = np.concatenate([p.reshape(-1) for p in parts] + [lam.reshape(-1), xnm])
        meta = np.concatenate([jk_arr, alive, rank_mask.reshape(-1)])
        raw = uploader.upload(np.concatenate([flat.view(np.uint8), meta.view(np.uint8)]))
        sizes = [p.size for p in parts] + [lam.size, bb]
        pieces = torch.split(raw[: flat.nbytes].view(_DTYPES[np_dtype]), sizes)
        factors = [pc.view(bb, m, r) for pc, m in zip(pieces, modes)]
        jk_d, alive_d, mask_d = torch.split(raw[flat.nbytes :].view(torch.int32), [bb, bb, bb * r])
        # Pre-zero each jackknife slot's left-out row (the solver re-zeroes
        # it after every mode-0 update).
        factors[0] = scale_jk_rows(factors[0], jk_d, 0.0)
        kt_b = Ktensor(tuple(factors), pieces[len(modes)].view(bb, r))
        return init_state(
            kt_b, x_norm, jk_fiber=jk_d, x_norm_model=pieces[-1],
            rank_mask=mask_d.view(bb, r).bool(), alive=alive_d.bool(), nnls=nnls,
            line_search=params.line_search, mixed_tol=mixed_tol,
        )

    # The graphs are freed when the call ends. A debug run reads the device
    # on the host in every iteration, so it is never captured.
    graphs = Graphs(dev) if chunked and dev.type == "cuda" and not params.debug else None
    uploader, fetcher = Pinned(dev), Pinned(dev)  # the call's pinned buffers, one each way

    def run_bucket(r: int, dq: collections.deque, b: int):
        models: list[CalsModelReport] = []
        pt = {"setup": 0.0, "solve": 0.0, "evict": 0.0, "capture": 0.0}
        counts = dict(captures=0, replays=0, stats_fetches=0, polish_sweeps=0, capture_s=0.0)
        t0 = time.perf_counter()
        slot_meta: list = [None] * b  # (id, rank, jk) per slot
        batch = [dq.popleft() for _ in range(min(b, len(dq)))]
        for slot, (i, kt, jk) in enumerate(batch):
            slot_meta[slot] = (i, kt.rank, jk)
        state = build_block_state(uploader, batch + [None] * (b - len(batch)), r)
        occupied = np.array([m is not None for m in slot_meta])
        if chunked:
            loop = ChunkLoop(iteration, x, x_norm, prepared, state, np.zeros(b, np.int64), occupied,
                             counts, uploader, fetcher, params, polish, graphs)
        else:
            loop = IterLoop(iteration, x, x_norm, prepared, state, np.zeros(b, np.int64), occupied,
                            counts, uploader, fetcher)
        pt["setup"] = time.perf_counter() - t0
        engine_iters = rounds = n_compactions = 0
        unpack = None  # the last round's results, unpacked while the device runs the next

        def unpack_results(kt_np, done):
            for i, off, rank in done:
                results[i] = _unpack_cols(kt_np, off, rank)

        while any(m is not None for m in slot_meta):
            t0 = time.perf_counter()
            stats, k = loop.advance(params.evict_batch, unpack)
            unpack = None
            engine_iters += k
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
                idx = uploader.upload(np.stack([slot_idx, col_idx]))
                flat, layout = _evicted_payload(loop.state, idx, params.result_wire_dtype)
                counts["stats_fetches"] += 1
                stats, lam, *factors = _split_payload(loop.fetcher.fetch(flat), layout)
                kt_np = Ktensor(tuple(f.astype(np_dtype, copy=False) for f in factors),
                                lam.astype(np_dtype, copy=False))
                refill_slots: list = []
                refill_items: list = []
                done = []
                for slot in evicted:
                    i, rank, _ = slot_meta[slot]
                    models.append(CalsModelReport(
                        id=i, rank=rank, iters=int(stats[1][slot]),
                        fit=float(stats[2][slot]), approx_error=float(stats[3][slot]),
                    ))
                    done.append((i, offs[slot], rank))
                    slot_meta[slot] = None
                    if dq:
                        item = dq.popleft()
                        slot_meta[slot] = (item[0], item[1].rank, item[2])
                        refill_slots.append(slot)
                        refill_items.append(item)
                    else:
                        keep[slot] = False
                unpack = functools.partial(unpack_results, kt_np, done)
                if refill_slots:
                    # Batched refill: one build of the fresh models' rows,
                    # written into their slots.
                    loop.refill(np.asarray(refill_slots), build_block_state(uploader, refill_items, r))
            if not keep.all():
                loop.kill(keep)
            pt["evict"] += time.perf_counter() - t0
            if evicted:
                rounds += 1
                if max_rounds_per_bucket is not None and rounds >= max_rounds_per_bucket:
                    break
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
        if unpack is not None:
            unpack()
        pt["capture"] = counts.pop("capture_s")
        pt["solve"] -= pt["capture"]
        return models, pt, engine_iters, counts

    for wave in waves:
        # Largest-work-first order, as in the JAX engine.
        items = sorted(
            ((r, buckets[r], b) for r, b in wave.items()),
            key=lambda t: (-t[0] * t[2], t[0]),
        )
        for r, dq, b in items:
            models, pt, engine_iters, counts = run_bucket(r, dq, b)
            report.models.extend(models)
            report.phase_times[r] = pt
            report.engine_iterations[r] = report.engine_iterations.get(r, 0) + engine_iters
            report.loop_counts[r] = counts

    report.models.sort(key=lambda m: m.id)
    # Unfinished models (max_rounds_per_bucket) are None.
    return [results.get(i) for i in range(len(queue))], report
