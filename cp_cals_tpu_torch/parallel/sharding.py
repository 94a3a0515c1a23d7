"""The (dp, tp) process mesh of a multi-device run (port of
``cp_cals_tpu/parallel/sharding.py``).

One process per device, joined by ``torch.distributed``. **dp** splits a
rank bucket's model batch: each rank holds a contiguous share of the
bucket's slots and runs the iteration on them alone, so no collective runs
inside an iteration. **tp** (``shard_mode0``) splits the tensor's mode 0:
each rank holds rows ``[start, stop)`` of X and the same rows of every
model's factor 0 (and of NNLS's ``active[0]``), and the iteration sums over
the tp group what the JAX package's SPMD partitioner sums (``TpRows``): the
MTTKRP of every other mode and the factor-0 gramians and column norms; and,
as GSPMD gathers the sharded operand around the Pallas apply, mode 0's
MTTKRP (for the apply kernel) or update (unfused) is gathered whole, so
that every rank normalizes all of mode 0.

Where JAX annotates shardings and lets XLA place the data, the port says
which rows of each leaf a rank holds: ``state_rows`` (a bucket's batch
slots), ``tensor_rows`` (mode 0), ``mode0_leaves`` (the leaves that carry
factor-0 rows, JAX's ``state_pspecs``). Two deliberate differences from
the JAX rules:
- the batch follows ``_axis_if_divisible`` as in JAX: a bucket whose batch
  dp does not divide is replicated on every rank;
- mode 0 is split into near-equal blocks whether or not tp divides it
  (the first ``I0 % tp`` ranks take one row more), since explicit row
  ranges need no even split as GSPMD's shardings do; a mode 0 shorter
  than tp is replicated. The bench tensor's 299 rows would otherwise
  never split.

The engine's host loop is SPMD: every rank takes the same decisions from
statistics that one ``Mesh.host_sum`` gathers after each chunk. Host-side
collectives (statistics, evicted results, state gathers for tail
compaction and checkpoints) run over a CPU gloo group: the data is on the
host already, and gloo on CUDA tensors has no all-gather. Each is an
all-reduce of zero-filled buffers, in which every rank writes only what it
holds and is first to hold (``Shard``), summed by their bytes: exact for
any dtype.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ktensor import Ktensor
from ..solvers.state import SolverState, tree_map


class Mesh:
    """The (dp, tp) grid over the processes of ``torch.distributed``'s
    default group, ``rank = dp_index * n_tp + tp_index`` (the JAX mesh's
    device order, ``reshape(n_dp, n_tp)``), and this rank's device.
    ``tp_group`` joins the ranks of this rank's dp row (they share its
    models and split mode 0), ``dp_group`` those of its tp column.
    ``counts`` holds the collectives run through the mesh and their host
    seconds: "tp" inside the iteration, "host" in the engine's loop.

    Without an initialized process group only a 1 x 1 mesh exists: a
    single process, every collective a no-op."""

    def __init__(self, n_dp: int, n_tp: int, device):
        self.n_dp, self.n_tp = int(n_dp), int(n_tp)
        self.device = torch.device(device)
        self.size = dist.get_world_size() if dist.is_initialized() else 1
        if self.n_dp < 1 or self.n_tp < 1 or self.n_dp * self.n_tp != self.size:
            raise ValueError(f"mesh dp={n_dp} x tp={n_tp} does not cover the {self.size} processes")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.dp_index, self.tp_index = divmod(self.rank, self.n_tp)
        self.tp_group = self.dp_group = self.host_group = None
        self.counts = dict(tp=0, tp_s=0.0, host=0, host_s=0.0)
        if self.size == 1:
            return
        # Every rank creates every group, in one order (new_group's rule).
        for d in range(self.n_dp):
            g = dist.new_group([d * self.n_tp + t for t in range(self.n_tp)])
            if d == self.dp_index:
                self.tp_group = g
        for t in range(self.n_tp):
            g = dist.new_group([d * self.n_tp + t for d in range(self.n_dp)])
            if t == self.tp_index:
                self.dp_group = g
        if dist.get_backend() != "gloo":
            self.host_group = dist.new_group(backend="gloo")

    @property
    def shape(self) -> dict:
        return {"dp": self.n_dp, "tp": self.n_tp}

    def host_sum(self, arrays: list) -> list:
        """Host arrays summed over every rank by their bytes, in one
        all-reduce over the CPU group: exact, for any dtype, where at most
        one rank holds a nonzero byte at each place (the callers zero-fill
        what a rank does not own)."""
        if self.size == 1:
            return arrays
        arrays = [np.ascontiguousarray(a) for a in arrays]
        raw = np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays]) if arrays else np.zeros(0, np.uint8)
        t0 = time.perf_counter()
        dist.all_reduce(torch.from_numpy(raw), group=self.host_group)
        self.counts["host"] += 1
        self.counts["host_s"] += time.perf_counter() - t0
        out, off = [], 0
        for a in arrays:
            out.append(raw[off : off + a.nbytes].view(a.dtype).reshape(a.shape))
            off += a.nbytes
        return out


def local_device(device=None) -> torch.device:
    """This process's device: as given, except that a CUDA device without an
    index is the local rank's card (``LOCAL_RANK``, torchrun's variable;
    0 without it)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(n_dp: int | None = None, n_tp: int = 1, device=None) -> Mesh:
    """Mesh over (dp, tp) of every process. Default: all of them on dp.
    ``device`` as ``local_device``."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_dp is None:
        n_dp = size // n_tp
    return Mesh(n_dp, n_tp, local_device(device))


def _axis_if_divisible(mesh: Mesh | None, axis: str, size: int) -> str | None:
    """Shard ``size`` over ``axis`` only when it divides evenly; otherwise
    replicate that dimension. Small tail buckets (batch 1-2 on a 4-wide dp
    axis) stay correct — they just don't get dp parallelism."""
    if mesh is None:
        return axis
    n = mesh.shape.get(axis, 1)
    return axis if n > 0 and size % n == 0 else None


def state_rows(mesh: Mesh | None, b: int) -> tuple[int, int]:
    """The batch slots ``[lo, hi)`` of a bucket of ``b`` slots this rank
    holds: its dp share, or every slot where dp does not divide ``b``."""
    if mesh is None or mesh.n_dp == 1 or _axis_if_divisible(mesh, "dp", b) is None:
        return 0, b
    n = b // mesh.n_dp
    return mesh.dp_index * n, (mesh.dp_index + 1) * n


def tensor_rows(mesh: Mesh | None, i0: int, shard_mode0: bool) -> tuple[int, int]:
    """The rows ``[start, stop)`` of tensor mode 0 (and of every factor 0)
    this rank holds: its near-equal tp block under ``shard_mode0`` (the
    module docstring), else every row."""
    if mesh is None or not shard_mode0 or mesh.n_tp == 1 or i0 < mesh.n_tp:
        return 0, i0
    q, extra = divmod(i0, mesh.n_tp)
    t = mesh.tp_index
    start = t * q + min(t, extra)
    return start, start + q + (t < extra)


class TpRows:
    """The iteration's view of a split mode 0: this rank's rows ``[start,
    stop)`` of ``size``; the sum over the tp group of a tensor every rank
    of the group holds whole, and the gather of a tensor of mode-0 rows
    (each an all-reduce on the device, over the run's backend). Each call adds to the mesh's "tp" counts. The iteration's collectives cannot be captured into a CUDA
    graph over gloo, so the engine runs a tp bucket's loop uncaptured."""

    def __init__(self, mesh: Mesh, start: int, stop: int, size: int):
        self.mesh, self.start, self.stop, self.size = mesh, start, stop, size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.mesh.tp_group)
        self.mesh.counts["tp"] += 1
        self.mesh.counts["tp_s"] += time.perf_counter() - t0
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [B, stop - start, ...], this rank's rows of mode 0 on axis 1,
        as [B, size, ...] on every rank of the group, bit for bit: each
        rank's rows in zeros, summed as integers of the same width (every
        place holds one rank's bits; gloo on CUDA has no all-gather)."""
        whole = t.new_zeros((t.shape[0], self.size) + tuple(t.shape[2:]))
        whole[:, self.start : self.stop] = t
        ints = {4: torch.int32, 8: torch.int64}[whole.element_size()]
        return self.sum(whole.view(ints)).view(whole.dtype)


def tp_rows(mesh: Mesh | None, i0: int, shard_mode0: bool) -> TpRows | None:
    """The iteration's ``TpRows``, or None where this rank holds all of mode 0."""
    start, stop = tensor_rows(mesh, i0, shard_mode0)
    return None if stop - start == i0 else TpRows(mesh, start, stop, i0)


def mode0_leaves(state: SolverState) -> list[bool]:
    """Per leaf of ``tree_leaves(state)``: whether its axis 1 holds factor-0
    rows (every Ktensor's factor 0, and ``active[0]``, ``backup_active[0]``
    under NNLS), which tp splits (JAX's ``state_pspecs``)."""
    flags: list[bool] = []

    def walk(t, rows0: bool) -> None:
        if isinstance(t, torch.Tensor):
            flags.append(rows0)
        elif isinstance(t, Ktensor):
            for n, f in enumerate(t.factors):
                walk(f, n == 0)
            walk(t.lam, False)
        elif hasattr(t, "_fields"):
            for name, v in zip(t._fields, t):
                if name in ("active", "backup_active"):
                    for n, a in enumerate(v):
                        walk(a, n == 0)
                else:
                    walk(v, False)
        else:
            for v in t:
                walk(v, False)

    walk(state, False)
    return flags


class Shard:
    """A bucket of ``b`` slots on the mesh (``mesh`` None: one process,
    every slot and row here, no collective): this rank's slots ``[lo, hi)``
    and mode-0 rows ``[r0, r1)`` of ``i0``, and the host gathers of the
    SPMD loop. A rank is the ``lead`` of its slots where it is the first
    that holds them (tp index 0, and dp index 0 if the batch is replicated),
    and the ``rows_lead`` of its factor-0 rows likewise: gathers take what
    leads hold and zeros from the rest."""

    def __init__(self, mesh: Mesh | None, b: int, rows: tuple[int, int, int]):
        self.mesh, self.b = mesh, b
        self.lo, self.hi = state_rows(mesh, b)
        self.r0, self.r1, self.i0 = rows
        if mesh is None:
            self.lead = self.rows_lead = True
            return
        slot_lead = self.hi - self.lo < b or mesh.dp_index == 0
        self.lead = slot_lead and mesh.tp_index == 0
        self.rows_lead = slot_lead and (self.r1 - self.r0 < self.i0 or mesh.tp_index == 0)

    def resized(self, b: int) -> "Shard":
        """The shard of a batch of ``b`` slots on the same mesh and rows."""
        return Shard(self.mesh, b, (self.r0, self.r1, self.i0))

    @property
    def trivial(self) -> bool:
        """One process holds everything: nothing to gather."""
        return self.mesh is None or self.mesh.size == 1

    def local(self, slots) -> np.ndarray:
        """Which of the global ``slots`` this rank holds (a mask)."""
        s = np.asarray(slots, np.int64)
        return (s >= self.lo) & (s < self.hi)

    def gather_slots(self, local: np.ndarray, axis: int = 0) -> np.ndarray:
        """A per-slot host array of this rank's slots (along ``axis``) as the
        global array, without a collective (``assemble`` sums them)."""
        shape = list(local.shape)
        shape[axis] = self.b
        out = np.zeros(shape, local.dtype)
        if self.lead:
            idx = [slice(None)] * local.ndim
            idx[axis] = slice(self.lo, self.hi)
            out[tuple(idx)] = local
        return out

    def place_state(self, leaves: list, flags: list) -> list:
        """This rank's host state leaves, each placed in the global leaf's
        zeros (batch slots on axis 0, factor-0 rows on axis 1)."""
        out = []
        for leaf, rows0 in zip(leaves, flags):
            shape = (self.b,) + tuple(leaf.shape[1:])
            if rows0:
                shape = shape[:1] + (self.i0,) + shape[2:]
            full = np.zeros(shape, leaf.dtype)
            if rows0 and self.rows_lead:
                full[self.lo : self.hi, self.r0 : self.r1] = leaf
            elif not rows0 and self.lead:
                full[self.lo : self.hi] = leaf
            out.append(full)
        return out

    def assemble(self, arrays: list) -> list:
        return arrays if self.trivial else self.mesh.host_sum(arrays)

    def gather_state(self, state: SolverState) -> list:
        """Every leaf of the bucket's state, whole, as host arrays on every
        rank (one host all-reduce)."""
        from ..utils.checkpoint import host_leaves

        leaves = host_leaves(state)
        if self.trivial:
            return leaves
        return self.assemble(self.place_state(leaves, mode0_leaves(state)))

    def whole_state(self, state: SolverState) -> SolverState:
        """The bucket's whole state (every slot, every row) on every rank, on
        the state's device (one host all-reduce where ranks split it)."""
        if self.lo == 0 and self.hi == self.b and self.r1 - self.r0 == self.i0:
            return state
        from ..utils.checkpoint import rebuild

        dev = state.iters.device
        return rebuild(state, [torch.from_numpy(a).to(dev) for a in self.gather_state(state)])

    def take(self, state: SolverState) -> SolverState:
        """This rank's part of a whole bucket state: its slots, and its rows
        of every factor-0 leaf."""
        flags = iter(mode0_leaves(state))

        def cut(leaf):
            leaf = leaf[self.lo : self.hi]
            return (leaf[:, self.r0 : self.r1] if next(flags) else leaf).contiguous()

        return tree_map(cut, state)


def make_sharded_step(params, mesh: Mesh, x: torch.Tensor, state: SolverState, shard_mode0: bool = False):
    """The batched CALS iteration of one rank of ``mesh``, with this rank's
    block of ``x`` and part of the whole batched ``state``; returns
    (step_fn, local_x, local_state), where ``step_fn(x, state,
    x_norm_full)`` is one iteration (the tp sums inside)."""
    from ..solvers.iteration import make_iteration

    x = torch.as_tensor(x).to(mesh.device)
    tp = tp_rows(mesh, x.shape[0], shard_mode0)
    start, stop = (tp.start, tp.stop) if tp is not None else (0, x.shape[0])
    shard = Shard(mesh, state.iters.shape[0], (start, stop, x.shape[0]))
    iteration = make_iteration(params, batched=True, tp=tp)
    return iteration, x[start:stop].contiguous(), shard.take(state)
