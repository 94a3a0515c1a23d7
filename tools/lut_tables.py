#!/usr/bin/env python3
"""Measure the port's committed MTTKRP lookup tables on the card.

    python3 tools/lut_tables.py [--retune] [--reps N]

For every bucket chip_smoke.py runs under mttkrp_method=AUTO
(``chip_smoke.auto_tables``: the bench workload in 3-D and 4-D, the NNLS
run, the README command's CALS and jackknife buckets, and every engine run
of the experiment harness, quick, full width and full size, at their
tiers), it
autotunes the (B, R, tier) entries the card's table lacks
(``utils/lut.autotune``: each method replayed from a CUDA graph, the least
of ``--reps``, the 10 % margin toward the twostep) into
``cp_cals_tpu_torch/lookup_tables/<device>/``; ``--retune`` measures every
entry anew. It prints each entry's pick and each candidate's ms per call,
copies the card's tables to ``chiprun_out/lookup_tables/`` and writes the
times to ``chiprun_out/lut_tables.json``. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the list of the script's buckets under AUTO)
from cp_cals_tpu_torch.utils import lut  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--retune", action="store_true")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    done, out = set(), []
    for modes, tier, batches in chip_smoke.auto_tables():
        for r, b in sorted(batches.items()):
            if (modes, tier, r, b) in done:
                continue
            done.add((modes, tier, r, b))
            tuned = args.retune or not lut.has_exact_entries(modes, r, b, tier, dev)
            if tuned:
                lut.autotune(modes, r, b, reps=args.reps, precision=tier, device=dev)
            table = lut._load(modes, dev)
            for n in range(len(modes)):
                key = lut._key(b, r, n, tier)
                times = lut.LAST_TIMES.get(key) if tuned else None
                out.append(dict(modes="-".join(map(str, modes)), tier=tier, B=b, R=r, mode=n, pick=table[key],
                                ms=times))
                print(f"{out[-1]['modes']} {tier} B={b} R={r} mode {n}: {table[key]}"
                      + (" (" + ", ".join(f"{m} {t:.4f}" for m, t in times.items()) + " ms)" if times else
                         " (committed)"), flush=True)
    seconds = time.perf_counter() - t0
    print(f"{len(out)} entries, {sum(e['ms'] is not None for e in out)} measured, in {seconds:.1f}s", flush=True)
    src = os.path.dirname(lut._table_path((1,), dev))
    dst = os.path.join("chiprun_out", "lookup_tables", os.path.basename(src))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    with open(os.path.join("chiprun_out", "lut_tables.json"), "w") as fh:
        json.dump(dict(card=chip_smoke.card_line(), seconds=seconds, entries=out), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
