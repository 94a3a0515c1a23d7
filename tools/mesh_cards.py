#!/usr/bin/env python3
"""The port's multi-device runs on several cards: one process per card,
joined over NCCL (``parallel.distributed.initialize``), every rank on its
own card.

    python3 -m torch.distributed.run --standalone --nproc_per_node=N tools/mesh_cards.py [--turns T]

A rehearsal on the CPU (gloo, a small tensor):

    python3 -m torch.distributed.run --standalone --nproc_per_node=4 tools/mesh_cards.py \\
        --device cpu --modes 29-31-11

1. The bench workload (299x301x41, 400 models of ranks 1-20, buckets
   4/8/12/16/20, buffer_size=2880, 10 forced iterations, the fused kernels
   pinned) at "highest" and at the bench tiers, on every rank alone,
   without a mesh: each rank's references, on its own card.
2. The same on every mesh of the N ranks: dp = N, tp = N, and with N = 4
   dp = 2 x tp = 2. Each rank's results against its reference of the same
   tier: iteration counts, bucket-iterations and stats fetches equal (the
   same chunks and eviction rounds; ``chip_smoke.mesh_diff``); the largest
   fit and relative reconstruction differences, held within
   ``chip_smoke.CROSS_TOL["highest"]`` at "highest" and recorded at the
   bench tiers (their bf16 roundings amplify a rank's other summation
   order in the degenerate high-rank models: ``chip_smoke.py`` phase 5c's
   "dp" against "dp highest"); its launches per kernel, and its
   collectives per bucket-iteration and their host seconds ("tp" in the
   iteration, "host" in the loop).
3. The walls, in turns: the runs alone, then each mesh, ``--turns`` times
   (runs of one turn start together on every rank, after a barrier).
4. J1 (299 leave-one-out replicates of a rank-5 model of the bench tensor)
   at 10 forced iterations under dp = N against each rank's run alone.

Rank 0 prints the card's name and power limit and writes
chiprun_out/mesh_cards_N.json (every rank's rows).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench workload and its settings)
from cp_cals_tpu_torch import AlsParams, cp_als, cp_cals, jk_cp_cals, launches  # noqa: E402
from cp_cals_tpu_torch import random_ktensor_host  # noqa: E402
from cp_cals_tpu_torch.parallel import distributed  # noqa: E402
from cp_cals_tpu_torch.parallel.sharding import local_device  # noqa: E402


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(run, dev):
    """``run()`` from launch counts at 0, on every rank at once; (result,
    wall, launches)."""
    sync(dev)
    dist.barrier()
    launches.reset()
    t0 = time.perf_counter()
    out = run()
    sync(dev)
    return out, time.perf_counter() - t0, launches.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--device", default=None, help="cpu for a rehearsal over gloo (default: the local rank's card)")
    p.add_argument("--modes", default=None, help="the bench tensor's modes for a rehearsal, e.g. 29-31-11")
    args = p.parse_args(argv)
    distributed.initialize(device=args.device)
    dev = local_device(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    modes = tuple(int(m) for m in args.modes.split("-")) if args.modes else chip_smoke.MODES
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    if rank == 0:
        print(card, flush=True)
        print(f"{world} ranks, backend {dist.get_backend()}, torch {torch.__version__}", flush=True)
    x_np, rng = chip_smoke.bench_tensor(modes)
    queue = chip_smoke.engine_queue(rng, modes)
    tiers = {"highest": {}, "bench": chip_smoke.BENCH_TIERS}
    meshes = {f"dp{world}": (world, 1), f"tp{world}": (1, world)}
    if world == 4:
        meshes["dp2 x tp2"] = (2, 2)
    runs = {}
    for tier, kw in tiers.items():
        params = chip_smoke.bench_params(**kw, **chip_smoke.pinned())
        runs[f"alone {tier}"] = lambda params=params: cp_cals(x_np, queue, params, device=dev)
        for name, (dp, tp) in meshes.items():
            mesh = distributed.pod_mesh(tp, device=dev)
            runs[f"{name} {tier}"] = lambda mesh=mesh, tp=tp, params=params: cp_cals(
                x_np, queue, params, mesh=mesh, shard_mode0=tp > 1)
            runs[f"{name} {tier}"].mesh = mesh
        cp_cals(x_np, queue[::80], params, device=dev)  # this process's first calls, outside the walls
    walls = {name: [] for name in runs}
    got = {}
    for _ in range(args.turns):
        for name, run in runs.items():
            mesh = getattr(run, "mesh", None)
            if mesh is not None:
                mesh.counts.update(tp=0, tp_s=0.0, host=0, host_s=0.0)
            got[name], wall, counts = timed(run, dev)
            walls[name].append(wall)
            if mesh is not None:
                got[name] = (got[name], counts, dict(mesh.counts))
    row = dict(rank=rank, device=str(dev), walls=walls, runs={})
    for name in (f"{m} {t}" for t in tiers for m in meshes):
        result, counts, coll = got[name]
        steps = sum(result[1].engine_iterations.values())
        tier = name.rsplit(" ", 1)[1]
        diffs = chip_smoke.mesh_diff(name, result, got[f"alone {tier}"], dev,
                                     tol=chip_smoke.CROSS_TOL["highest"] if tier == "highest" else None)
        row["runs"][name] = dict(**diffs, launches=counts, collectives=coll,
                                 bucket_iterations=steps,
                                 captures=sum(c["captures"] for c in result[1].loop_counts.values()),
                                 tp_per_bucket_iteration=coll["tp"] / steps,
                                 tp_ms_per_bucket_iteration=1e3 * coll["tp_s"] / steps,
                                 host_per_bucket_iteration=coll["host"] / steps,
                                 host_ms_per_bucket_iteration=1e3 * coll["host_s"] / steps)
    # J1 at 10 forced iterations, alone and under dp = N.
    kt0 = random_ktensor_host(np.random.default_rng(chip_smoke.JK_SEED), modes, chip_smoke.JK_RANK)
    kt5, _ = cp_als(x_np, kt0, AlsParams(precision="highest", tol=1e-8, max_iterations=500), device=dev)
    j1 = chip_smoke.j1_forced()
    alone, wall1, _ = timed(lambda: jk_cp_cals(x_np, [kt5], j1, device=dev), dev)
    mesh = distributed.pod_mesh(1, device=dev)
    dp, wall_dp, counts = timed(lambda: jk_cp_cals(x_np, [kt5], j1, mesh=mesh), dev)
    row["runs"][f"J1 dp{world}"] = dict(
        **chip_smoke.mesh_diff("J1", (dp.results[0], dp.cals_report), (alone.results[0], alone.cals_report), dev,
                               jk=True),
        launches=counts, collectives=dict(mesh.counts), walls=dict(alone=wall1, mesh=wall_dp))
    rows = [None] * world
    dist.all_gather_object(rows, row)
    if rank == 0:
        for r in rows:
            for name, v in r["runs"].items():
                diffs = {k: v[k] for k in v if k.startswith("max_")}
                print(f"rank {r['rank']} ({r['device']}) {name}: {diffs}; launches "
                      f"{ {k: n for k, n in v['launches'].items() if n} }; collectives {v['collectives']}", flush=True)
            print(f"rank {r['rank']} walls (s, median of {args.turns}): "
                  + ", ".join(f"{k} {statistics.median(w):.4f}" for k, w in r["walls"].items()), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", f"mesh_cards_{world}.json"), "w") as fh:
            json.dump(dict(card=card, world=world, backend=dist.get_backend(), modes=modes, rows=rows), fh, indent=1)
        print(json.dumps({"ok": True, "world": world, "card": card}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
