"""Concurrent ALS (CALS) engine: many CP models of varying rank fitted in
one stream (port of ``cp_cals_tpu/solvers/cals.py`` for explicit host
Ktensor queues).

Models are padded to a rank bucket and packed into batched slots
``[B, I_n, R]``; one global padded-column budget (``buffer_size``) is split
across buckets (``allocate_bucket_batches``). Each bucket runs lock-step
ALS iterations until at least one live model converges, then the host
evicts converged models (one packed gather of their true-rank columns),
refills the vacated slots from the queue by a masked select, and repeats.
Padded columns and vacant slots are inert, so concurrency is invisible to
each model's trajectory.

Differences from the JAX engine in this slice (ROADMAP section 3):
the run-until-evict loop is a host loop with one small stats fetch per
iteration instead of a device while-loop; buckets run one after another
(``bucket_threads`` is accepted and not used); results are fetched
synchronously. Device-generated ``RandomKtensorSpec`` queues, meshes,
checkpoints and traces raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..config import CalsParams, check_supported, not_ported
from ..device import resolve_device
from ..ktensor import Ktensor, scale_jk_rows
from .iteration import make_iteration
from .state import SolverState, init_state, tree_map, tree_where


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
    # the host loop, so kernel launches per mode equal the sum of these).
    engine_iterations: dict = field(default_factory=dict)
    models: list = field(default_factory=list)
    phase_times: dict = field(default_factory=dict)
    materialize_s: float = 0.0


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


def _pack_evict_stats(state: SolverState) -> torch.Tensor:
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


_COL_QUANTUM = 128


def _evict_col_indices(evicted, slot_meta):
    """Packed-column index map for ``_gather_cols``: per evicted model its
    true-rank columns, padded to a multiple of ``_COL_QUANTUM``."""
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


def _gather_cols(kt: Ktensor, slot_idx, col_idx, wire_dtype: str | None = None):
    """Evicted models' true rank columns as one packed [n_cols, I_n] block
    per mode (+ lam [n_cols]), fetched to the host. ``wire_dtype`` rounds
    the factor payload to a half-width type for the transfer; lam stays in
    full precision."""
    dev = kt.lam.device
    si = torch.as_tensor(slot_idx, device=dev)
    ci = torch.as_tensor(col_idx, device=dev)
    factors = []
    for f in kt.factors:
        g = f[si, :, ci]
        if wire_dtype is not None:
            g = g.to(_WIRE[wire_dtype])
        g = g.cpu()
        if g.dtype == torch.bfloat16:  # numpy has no bfloat16
            g = g.float()
        factors.append(g.numpy())
    return Ktensor(tuple(factors), kt.lam[si, ci].cpu().numpy())


def _unpack_cols(kt_np: Ktensor, off: int, rank: int, np_dtype) -> Ktensor:
    """One model out of a packed-column gather, in the queue dtype."""
    return Ktensor(
        tuple(
            np.ascontiguousarray(f[off : off + rank].T).astype(np_dtype, copy=False)
            for f in kt_np.factors
        ),
        np.asarray(kt_np.lam[off : off + rank]).astype(np_dtype, copy=False),
    )


def _norms(x: torch.Tensor, with_jk: bool):
    """(|X| on the device in x's dtype, leave-one-out norms per mode-0 fiber
    on the host or None). |X| reduces in at least float32; the
    leave-one-out norms are ``jackknife_norms``."""
    from .jackknife import jackknife_norms

    wide = torch.promote_types(x.dtype, torch.float32)
    x_norm = torch.linalg.vector_norm(x.to(wide).reshape(-1)).to(x.dtype)
    if not with_jk:
        return x_norm, None
    return x_norm, jackknife_norms(x).cpu().numpy()


def run_until_evict(iteration, x, state, x_norm, prepared, evict_batch: int = 1):
    """Iterate the bucket until at least one live model has converged (or,
    with ``evict_batch > 1``, until that many have or none is left
    unconverged). With ``evict_batch > 1`` converged models are frozen by a
    select, so their trajectories are bit-identical to immediate eviction.

    The host reads one small stats tensor per iteration. On entry no live
    model is converged (the caller has evicted them all), so the body runs
    at least once, as the JAX package's device while-loop does.
    Returns (state, host stats [5, B], iterations run).
    """
    n = 0
    while True:
        new = iteration(x, state, x_norm, prepared)
        if evict_batch > 1:
            new = tree_where(state.converged & state.alive, state, new)
        state = new
        n += 1
        stats = _pack_evict_stats(state).cpu().numpy()
        n_conv = int(np.count_nonzero(stats[0]))
        if evict_batch <= 1:
            if n_conv:
                return state, stats, n
        elif n_conv >= evict_batch or not np.count_nonzero(stats[4]):
            return state, stats, n


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

    x: dense 3-D tensor (NumPy or torch); it is cast to the queue's dtype.
    queue: Ktensors with NumPy or torch factors [I_n, R] and lam [R].
    jk_fibers: optional per-model jackknifed mode-0 fiber (-1 = regular
    model); leave-one-out norms are computed once unless ``x_norms_jk`` is
    given. device: None means the CUDA card (raises without one); pass
    "cpu" to run the plain PyTorch versions of the kernels.
    """
    if mesh is not None or shard_mode0:
        raise not_ported("multi-device runs", "queue 1 item 10")
    if trace is not None:
        raise not_ported("trace", "queue 1 item 8")
    if checkpoint_dir is not None or resume:
        raise not_ported("checkpoint/resume", "queue 1 item 8")
    if max_rounds_per_bucket is not None:
        raise not_ported("max_rounds_per_bucket", "queue 1 item 8")
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
    iteration = make_iteration(params, batched=True, has_jk=has_jk)
    prepared = iteration.prepare(x)  # loop-invariant layouts, once per solve
    results: dict[int, Ktensor] = {}

    def build_block_state(batch_slots, r: int, bb: int) -> SolverState:
        """A [bb]-wide state from per-slot intake items ((id, ktensor, jk)
        or None for a dead slot): one float and one int upload, then the
        gramians of the initial guesses on the device."""
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
        flat = torch.from_numpy(
            np.concatenate([p.reshape(-1) for p in parts] + [lam.reshape(-1), xnm])
        ).to(dev)
        meta = torch.from_numpy(
            np.concatenate([jk_arr, alive, rank_mask.reshape(-1)])
        ).to(dev)
        sizes = [p.size for p in parts] + [lam.size, bb]
        pieces = torch.split(flat, sizes)
        factors = [pc.view(bb, m, r) for pc, m in zip(pieces, modes)]
        jk_d, alive_d, mask_d = torch.split(meta, [bb, bb, bb * r])
        # Pre-zero each jackknife slot's left-out row (the solver re-zeroes
        # it after every mode-0 update).
        factors[0] = scale_jk_rows(factors[0], jk_d, 0.0)
        kt_b = Ktensor(tuple(factors), pieces[len(modes)].view(bb, r))
        return init_state(
            kt_b, x_norm, jk_fiber=jk_d, x_norm_model=pieces[-1],
            rank_mask=mask_d.view(bb, r).bool(), alive=alive_d.bool(),
        )

    def run_bucket(r: int, dq: collections.deque, b: int):
        models: list[CalsModelReport] = []
        pt = {"setup": 0.0, "solve": 0.0, "evict": 0.0}
        t0 = time.perf_counter()
        slot_meta: list = [None] * b  # (id, rank, jk) per slot
        batch = [dq.popleft() for _ in range(min(b, len(dq)))]
        for slot, (i, kt, jk) in enumerate(batch):
            slot_meta[slot] = (i, kt.rank, jk)
        state = build_block_state(batch + [None] * (b - len(batch)), r, b)
        pt["setup"] = time.perf_counter() - t0
        engine_iters = 0
        n_compactions = 0
        while any(m is not None for m in slot_meta):
            t0 = time.perf_counter()
            state, stats, k = run_until_evict(
                iteration, x, state, x_norm, prepared, params.evict_batch
            )
            engine_iters += k
            pt["solve"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            conv = stats[0] != 0
            keep = np.ones(b, bool)
            evicted = [s for s in range(b) if slot_meta[s] is not None and conv[s]]
            if evicted:
                slot_idx, col_idx, offs = _evict_col_indices(evicted, slot_meta)
                kt_np = _gather_cols(state.kt, slot_idx, col_idx, params.result_wire_dtype)
                refills: list = []
                for slot in evicted:
                    i, rank, _ = slot_meta[slot]
                    models.append(CalsModelReport(
                        id=i, rank=rank, iters=int(stats[1][slot]),
                        fit=float(stats[2][slot]), approx_error=float(stats[3][slot]),
                    ))
                    results[i] = _unpack_cols(kt_np, offs[slot], rank, np_dtype)
                    slot_meta[slot] = None
                    if dq:
                        item = dq.popleft()
                        slot_meta[slot] = (item[0], item[1].rank, item[2])
                        refills.append((slot, item))
                    else:
                        keep[slot] = False
                if refills:
                    # Batched refill: one block build + one masked select.
                    batch_slots: list = [None] * b
                    mask = np.zeros((b,), bool)
                    for slot, item in refills:
                        batch_slots[slot] = item
                        mask[slot] = True
                    fresh = build_block_state(batch_slots, r, b)
                    state = tree_where(torch.from_numpy(mask).to(dev), fresh, state)
            if not keep.all():
                state = state._replace(
                    alive=state.alive & torch.from_numpy(keep).to(dev)
                )
            pt["evict"] += time.perf_counter() - t0
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
                idx_t = torch.as_tensor(idx, device=dev)
                state = tree_map(lambda leaf: leaf[idx_t], state)
                slot_meta = [slot_meta[s] for s in idx]
                b //= 2
                n_compactions += 1
        return models, pt, engine_iters

    for wave in waves:
        # Largest-work-first order, as in the JAX engine.
        items = sorted(
            ((r, buckets[r], b) for r, b in wave.items()),
            key=lambda t: (-t[0] * t[2], t[0]),
        )
        for r, dq, b in items:
            models, pt, engine_iters = run_bucket(r, dq, b)
            report.models.extend(models)
            report.phase_times[r] = pt
            report.engine_iterations[r] = report.engine_iterations.get(r, 0) + engine_iters

    report.models.sort(key=lambda m: m.id)
    return [results.get(i) for i in range(len(queue))], report
