"""MTTKRP method micro-benchmark CLI (port of
``cp_cals_tpu/bench_mttkrp.py``): for each (batch, rank) of a grid, time
every MTTKRP method the fused gate takes per mode (``utils/lut.autotune``:
CUDA-graph replays on the card, the least of ``--reps``), print one line
per (batch, rank) and the table of winners as JSON, and store the winners
in the lookup tables that ``mttkrp_method=AUTO`` reads
(``cp_cals_tpu_torch/lookup_tables/<device>/``).

Usage (on the card; ``--device cpu`` times the plain versions on the host):
  python -m cp_cals_tpu_torch.bench_mttkrp -t 299-301-41 --ranks 4,8,12,16,20 \\
      --batches 96,64 --precision highest,default
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-t", "--tensor", default="299-301-41")
    p.add_argument("--ranks", default="4,8,16,32")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--batches", default=None,
                   help="comma list of batch sizes (overrides --batch); sweep the sizes the engine "
                        "allocates, e.g. each bucket's batch for the run's buffer_size")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--precision", default="high",
                   help="comma list of precision tiers to tune (highest, high, default)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from .device import resolve_device
    from .utils.lut import LAST_TIMES, _key, autotune

    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.tensor.split("-"))
    ranks = [int(r) for r in args.ranks.split(",")]
    batches = [int(b) for b in args.batches.split(",")] if args.batches else [args.batch]
    tiers = args.precision.split(",")
    table = {}
    for tier in tiers:
        for b in batches:
            for r in ranks:
                winners = autotune(modes, rank=r, batch=b, dtype=torch.float32, reps=args.reps,
                                   precision=tier, device=dev)
                core = _key(b, r, 0, tier).rpartition(":")[0]
                table[core] = winners
                times = "; ".join(
                    f"mode {n}: " + ", ".join(f"{m} {t:.4f}" for m, t in LAST_TIMES[_key(b, r, n, tier)].items())
                    for n in range(len(modes)))
                print(f"rank {r:4d} batch {b:4d} {tier}: {winners} (ms per call: {times})", flush=True)
    print(json.dumps(table))


if __name__ == "__main__":
    main()
