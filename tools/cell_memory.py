"""The device memory of a benchmark cell's job, outside the harness.

    python3 tools/cell_memory.py --workload cube500.select50_high --seed 7 [--jobs 2]

Makes the cell's inputs from the seed (``cals_bench/jobs``), then reads the
caching allocator: the peak of allocated bytes while the inputs were made;
after them, the peak of the warm-up job (which captures the cell's CUDA
graphs) and of ``--jobs`` later jobs (which replay them), the bytes held
between jobs, the bytes reserved, and the reserved and allocated bytes of
each memory pool (the caching allocator's own, and each pool of captured
graphs). Also the layout policy ``mode_layouts`` resolves to, the lookup
table's decisions in the warm-up, and the captures and kept graphs taken.
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["CP_CALS_NO_AUTOTUNE"] = "1"


def pools() -> dict:
    """[reserved, allocated] bytes by memory pool id."""
    import torch

    out: dict = {}
    for seg in torch.cuda.memory_snapshot():
        d = out.setdefault(str(seg.get("segment_pool_id", "?")), [0, 0])
        d[0] += seg["total_size"]
        d[1] += seg["allocated_size"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from cals_bench.jobs import job_class
    from cals_bench.registry import Registry
    from cp_cals_tpu_torch import config
    from cp_cals_tpu_torch.utils import lut

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    dev = torch.device("cuda")
    job = job_class(traffic["job"])(cfg, traffic, args.seed, dev)
    torch.cuda.synchronize(dev)
    rec = dict(card=torch.cuda.get_device_name(dev), workload=args.workload, seed=args.seed,
               policy=config.resolve_layouts(job.params, job.x, dev), inputs_peak=torch.cuda.max_memory_allocated(dev),
               held_after_inputs=torch.cuda.memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    lut.reset_lookup_stats()
    t0 = time.perf_counter()
    out = job.run()
    torch.cuda.synchronize(dev)
    rec.update(warm_up_s=time.perf_counter() - t0, lookups=dict(lut.LOOKUP_STATS),
               warm_up_peak=torch.cuda.max_memory_allocated(dev),
               captures=sum(c["captures"] for c in out.report.loop_counts.values()))
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(args.jobs):
        t0 = time.perf_counter()
        out = job.run()
        walls.append(time.perf_counter() - t0)
    rec.update(job_walls_s=walls, jobs_peak=torch.cuda.max_memory_allocated(dev),
               held_between_jobs=torch.cuda.memory_allocated(dev), reserved=torch.cuda.memory_reserved(dev),
               graph_reuses=sum(c["graph_reuses"] for c in out.report.loop_counts.values()),
               engine_iterations=out.report.engine_iterations, pools=pools())
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
