"""Autotune the MTTKRP lookup table over the grid the engine runs (the
counterpart of ``scripts/tune_lut_grid.py``: its flags, defaults and keys).

Given a tensor shape and a queue (``--ranks MIN:MAX:COPIES``, ``--buckets``,
``--buffer``), the programs are every (bucket rank, batch) the wave
allocator emits, wave by wave: the port's bucket demands
(``solvers/cals.py:precompile_buckets``'s ``Counter`` of ``bucket_rank``)
through ``allocate_bucket_batches``, plus each allocation's tail-compaction
halving ladder (``--tail-depth``, default the engine's
``CalsParams().tail_compaction_depth``). The ladder is the engine's own
(``solvers/cals.py``: ``b //= 2`` while ``b > 1``, at most
``tail_compaction_depth`` times), and the script's. Where the two part:
after a compaction the engine keeps the methods it resolved at the
allocated batch and looks nothing up at the half batch, so only the
allocated programs are lookups the engine makes (``engine_programs``); the
ladder's entries are tuned as the script tunes them, for the table's other
readers (nearest-entry lookups, other queues).

For each program ``utils/lut.ensure_methods`` autotunes and stores the
entries of the tier (``--precision``) that the table under ``--tables``
lacks (default: the committed root, ``cp_cals_tpu_torch/lookup_tables/``);
an entry present is never measured again. ``LOOKUP_STATS`` (exact, nearest,
heuristic) of one ``lookup_methods`` pass over every program is taken
before the tuning and again after it.

    python -m cp_cals_tpu_torch.profiles.tune_lut_grid [-t 299-301-41]
        [--ranks 1:20:20] [--buckets 4,8,16,20] [--buffer 5760]
        [--precision default] [--tail-depth 2] [--reps 3]
        [--tables DIR] [--device cuda|cpu] [--out chiprun_out]

Writes ``lut_grid_<tensor>_<tier>.json`` into ``--out``: the script's
``modes``, ``precision``, ``device`` and ``programs`` (``"BxR"`` -> each
mode's method), plus ``card``, ``lookup_stats_before`` /
``lookup_stats_after``, ``seconds`` per program and ``engine_programs``.
On the CPU (``--device cpu``) the candidates are timed on the host's clock
into the ``cpu-cpu`` table of ``--tables``.
"""

from __future__ import annotations

import argparse
import collections
import os
import time

import torch

from ..config import CalsParams
from ..device import resolve_device
from ..experiments import device_line
from ..solvers.cals import allocate_bucket_batches, bucket_rank
from ..utils import lut
from . import _timing as tm


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-t", "--tensor", default="299-301-41", help="mode dims, e.g. 299-301-41")
    p.add_argument("--ranks", default="1:20:20", help="MIN:MAX:COPIES queue spec (bench default 1:20:20)")
    p.add_argument("--buckets", default="4,8,16,20")
    p.add_argument("--buffer", type=int, default=5760)
    p.add_argument("--precision", default="default",
                   help="matmul tier to tune at (the bench's production MTTKRP tier is 'default')")
    p.add_argument("--tail-depth", type=int, default=CalsParams().tail_compaction_depth)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tables", default=lut._ROOT, help="the lookup tables' root (default: the committed one)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default=os.path.dirname(tm.OUT_DIR))
    return p


def allocations(ranks: str, buckets, buffer: int) -> list[dict[int, int]]:
    """The engine's waves ({bucket rank: batch} each) for the queue
    ``MIN:MAX:COPIES``."""
    lo, hi, copies = (int(v) for v in ranks.split(":"))
    demands = collections.Counter(bucket_rank(r, buckets) for r in range(lo, hi + 1) for _ in range(copies))
    return allocate_bucket_batches(dict(demands), buffer)


def programs(ranks: str, buckets, buffer: int, tail_depth: int) -> list[tuple[int, int]]:
    """Every (rank, batch) of the waves and of their halving ladders, sorted."""
    jobs: set[tuple[int, int]] = set()
    for wave in allocations(ranks, buckets, buffer):
        for r, b in wave.items():
            bb = b
            jobs.add((r, bb))
            for _ in range(tail_depth):
                if bb <= 1:
                    break
                bb //= 2
                jobs.add((r, bb))
    return sorted(jobs)


def lookup_pass(modes, jobs, tier: str, dev) -> dict:
    """``LOOKUP_STATS`` of one ``lookup_methods`` over ``jobs``."""
    lut.reset_lookup_stats()
    for r, b in jobs:
        lut.lookup_methods(modes, r, b, tier, torch.float32, dev)
    out = dict(lut.LOOKUP_STATS)
    lut.reset_lookup_stats()
    return out


def run(args) -> dict:
    dev = resolve_device(args.device)
    modes = tuple(int(d) for d in args.tensor.split("-"))
    buckets = tuple(int(r) for r in args.buckets.split(","))
    jobs = programs(args.ranks, buckets, args.buffer, args.tail_depth)
    engine = sorted({(r, b) for wave in allocations(args.ranks, buckets, args.buffer) for r, b in wave.items()})
    card = device_line(dev)
    print(card, flush=True)
    committed_root, lut._ROOT = lut._ROOT, args.tables
    try:
        before = lookup_pass(modes, jobs, args.precision, dev)
        print(f"# shape {modes}, {len(jobs)} (rank, batch) programs, tier={args.precision}, tables {args.tables}; "
              f"lookups before {before}", flush=True)
        results, seconds = {}, {}
        for r, b in jobs:
            t0 = time.perf_counter()
            methods = lut.ensure_methods(modes, r, b, dtype=torch.float32, precision=args.precision,
                                         reps=args.reps, device=dev)
            dt = time.perf_counter() - t0
            results[f"{b}x{r}"] = list(methods)
            seconds[f"{b}x{r}"] = dt
            print(f"B={b:4d} R={r:3d} -> {methods}  ({dt:.1f}s)", flush=True)
        after = lookup_pass(modes, jobs, args.precision, dev)
    finally:
        lut._ROOT = committed_root
    print(f"lookups after {after}", flush=True)
    out = {
        "modes": list(modes),
        "precision": args.precision,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "programs": results,
        "card": card,
        "tables": args.tables,
        "queue": {"ranks": args.ranks, "buckets": list(buckets), "buffer": args.buffer,
                  "tail_depth": args.tail_depth},
        "engine_programs": [f"{b}x{r}" for r, b in engine],
        "lookup_stats_before": before,
        "lookup_stats_after": after,
        "seconds": seconds,
    }
    path = os.path.join(args.out, f"lut_grid_{args.tensor}_{args.precision}.json")
    tm.write(path, out)
    print(f"wrote {path}")
    return out


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
