"""Checkpoint/resume of solver state (port of
``cp_cals_tpu/utils/checkpoint.py``).

Every bit of a bucket's progress lives in one ``SolverState`` plus the
host's slot metadata, so a snapshot is an ``.npz`` of the state's leaves
(``leaf_0`` ... in the port's field order, the ``HiState`` and ``LsState``
carries included) and a JSON sidecar (the structure, the leaf count and the
caller's metadata). The CALS engine writes one per bucket after every
eviction round (``BucketSnapshot``: the state, the host's slot metadata and
the finished models, the JAX engine's files and keys); the jackknife driver
passes its checkpoints through. On a mesh the engine gathers the bucket's
state whole on every rank and the coordinator alone writes; on resume every
rank loads the files and keeps its own slots and rows.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ktensor import Ktensor
from ..solvers.graph_loop import NP_DTYPES
from ..solvers.state import SolverState, tree_leaves


def _base(path: str) -> str:
    return path[: -len(".npz")] if path.endswith(".npz") else path


def _structure(tree) -> str:
    """The state's structure as text: field names, ``*`` for a leaf."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if hasattr(tree, "_fields"):
        inner = ",".join(f"{k}={_structure(v)}" for k, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    return "(" + ",".join(_structure(v) for v in tree) + ")"


def rebuild(template, leaves):
    """A state of ``template``'s structure from its leaves in field order."""
    leaves = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(leaves)
        parts = [build(p) for p in t]
        return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)

    return build(template)


def host_leaves(state: SolverState) -> list[np.ndarray]:
    """The state's leaves on the host, in field order, from one copy of
    their bytes packed on the device."""
    leaves = tree_leaves(state)
    raw = torch.cat([leaf.reshape(-1).view(torch.uint8) for leaf in leaves]).cpu().numpy()
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel() * leaf.element_size()
        np_dtype = np.bool_ if leaf.dtype == torch.bool else NP_DTYPES[leaf.dtype]
        out.append(raw[off : off + n].view(np_dtype).reshape(tuple(leaf.shape)))
        off += n
    return out


def save_state(path: str, state: SolverState, meta: dict | None = None, leaves: list | None = None) -> None:
    """Write the snapshot of ``state``: its host ``leaves`` where given (a
    multi-process run's state gathered whole, ``parallel.sharding.Shard.
    gather_state``), else its own."""
    leaves = host_leaves(state) if leaves is None else leaves
    np.savez_compressed(_base(path) + ".npz", **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    side = {"treedef": _structure(state), "n_leaves": len(leaves)}
    if meta:
        side["meta"] = meta
    with open(_base(path) + ".meta.json", "w") as f:
        json.dump(side, f)


def load_state(path: str, template: SolverState) -> tuple[SolverState, dict]:
    """Restore into the structure of ``template``, on its leaves' device
    (the shapes must match)."""
    leaves = tree_leaves(template)
    with np.load(_base(path) + ".npz") as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint at {path!r} has {len(data.files)} state leaves "
                f"but the current SolverState layout has {len(leaves)} — it "
                "was written by a different library version and cannot be "
                "resumed; restart the run without resume=True"
            )
        loaded = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for a, b in zip(loaded, leaves):
        if a.shape != tuple(b.shape):
            raise ValueError(f"shape mismatch {a.shape} vs {tuple(b.shape)}")
    tensors = [torch.from_numpy(a).to(b.device) for a, b in zip(loaded, leaves)]
    return rebuild(template, tensors), _meta(path) or {}


def _meta(path: str) -> dict | None:
    """The caller's metadata in a snapshot's sidecar; None without one."""
    sidecar = _base(path) + ".meta.json"
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as f:
        return json.load(f).get("meta", {})


class BucketSnapshot:
    """One engine bucket's files in a checkpoint dir: its state
    (``bucket_r{rank}``, ``save_state``'s), whose metadata holds the slots
    (``slot_meta``: [id, rank, jackknife fiber] per slot, null where vacant),
    ``bucket_rank`` and the finished models' records (``done``: [id, rank,
    iters, fit, error] each), and the finished models' factors and lam
    (``done_r{rank}.npz``: ``{id}_f{mode}`` and ``{id}_lam``)."""

    def __init__(self, checkpoint_dir: str, r: int):
        self.r = r
        self.state_path = os.path.join(checkpoint_dir, f"bucket_r{r}")
        self.done_path = os.path.join(checkpoint_dir, f"done_r{r}.npz")

    def save(self, state: SolverState, slot_meta: list, done_meta: list, results: dict, leaves=None) -> None:
        """The bucket's state (``leaves`` as ``save_state`` takes them), its
        slots, and its finished models (``done_meta``; arrays by id in
        ``results``)."""
        arrays = {}
        for mid, *_ in done_meta:
            kt = results[mid]
            for m, f in enumerate(kt.factors):
                arrays[f"{mid}_f{m}"] = f
            arrays[f"{mid}_lam"] = kt.lam
        if arrays:
            np.savez(self.done_path, **arrays)
        save_state(self.state_path, state, {
            "slot_meta": [list(m) if m is not None else None for m in slot_meta],
            "bucket_rank": self.r, "done": done_meta,
        }, leaves=leaves)

    def load(self, dq, template, n_modes: int) -> tuple | None:
        """None where no snapshot was written; else (slot metadata, finished
        models' records, the state in the structure of ``template(batch)``,
        the finished models by id). The models the snapshot holds, finished
        or in a slot, leave the bucket's queue ``dq`` ((id, model, jk)
        items)."""
        meta = _meta(self.state_path)
        if meta is None:
            return None
        slot_meta = [tuple(m) if m is not None else None for m in meta["slot_meta"]]
        done_meta = [list(m) for m in meta.get("done", [])]
        state, _ = load_state(self.state_path, template(len(slot_meta)))
        held = {int(m[0]) for m in done_meta} | {int(m[0]) for m in slot_meta if m is not None}
        rest = [item for item in dq if item[0] not in held]
        dq.clear()
        dq.extend(rest)
        if not done_meta:
            return slot_meta, done_meta, state, {}
        with np.load(self.done_path) as a:
            done = {int(i): Ktensor(tuple(a[f"{int(i)}_f{m}"] for m in range(n_modes)), a[f"{int(i)}_lam"])
                    for i, *_ in done_meta}
        return slot_meta, done_meta, state, done
