#!/usr/bin/env python3
"""Lawson-Hanson against block principal pivoting on the NNLS workload's
rank-8 bucket, in float32 and in float64.

    python3 tools/nnls_witness.py [--device cpu|cuda] [--threads N]

Runs the 40 models of ranks 5-8 of chip_smoke.py's NNLS problem (100^3,
50 forced iterations, bucket 8) through ``cp_cals`` with each algorithm,
in float32 at "high" and in float64 at "highest", and prints, per dtype,
the largest |fit difference| between the algorithms with the ids and ranks
of the models that part by more than 1e-4, and each float32 run against
the float64 run of the same algorithm. Every NNLS update of the runs is
also checked after it returns: a row whose result breaks the conditions
the solver stops on (an active entry of gradient above the solver's tol,
or a passive entry below -tol) ended at its trip bound unconverged; those
rows are counted per run. Writes chiprun_out/nnls_witness.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the NNLS problem and its settings)

BUCKET, PART = 8, 1e-4
RUNS = {"float32": (np.float32, "high"), "float64": (np.float64, "highest")}


class Unconverged:
    """Wraps the iteration's NNLS update: counts the rows and updates whose
    result breaks the solver's stopping conditions."""

    def __init__(self, it):
        self.it, self.real = it, it.update_factor_nnls
        self.rows = self.total = 0

    def __call__(self, g, h, warm, max_outer=0, algorithm="bpp"):
        import torch

        u, act = self.real(g, h, warm, max_outer, algorithm)
        eps = torch.finfo(h.dtype).eps
        tol = 10.0 * eps * torch.abs(h).sum(-2).amax(-1) * h.shape[-1]  # [B]
        w = g - torch.matmul(u, h)
        bad = (act & (w > tol[:, None, None])) | (~act & (u < -tol[:, None, None]))
        self.rows += int(bad.any(-1).sum())
        self.total += bad.shape[0] * bad.shape[1]
        return u, act

    def __enter__(self):
        self.it.update_factor_nnls = self
        return self

    def __exit__(self, *exc):
        self.it.update_factor_nnls = self.real


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    import torch

    from cp_cals_tpu_torch import Ktensor, cp_cals
    from cp_cals_tpu_torch.solvers import iteration
    from cp_cals_tpu_torch.solvers.cals import bucket_rank

    if args.threads:
        torch.set_num_threads(args.threads)
    x, queue = chip_smoke.nn_problem()
    ids = [i for i, kt in enumerate(queue) if bucket_rank(kt.rank, chip_smoke.NN_BUCKETS) == BUCKET]
    ranks = np.array([queue[i].rank for i in ids])
    fits, runs = {}, {}
    for name, (dt, prec) in RUNS.items():
        q = [Ktensor(tuple(f.astype(dt) for f in queue[i].factors), queue[i].lam.astype(dt)) for i in ids]
        for alg in ("bpp", "lawson_hanson"):
            t0 = time.perf_counter()
            with Unconverged(iteration) as unc:
                _, rep = cp_cals(x.astype(dt), q, chip_smoke.nn_params(
                    precision=prec, bucket_ranks=(BUCKET,), nnls_algorithm=alg), device=args.device)
            fits[name, alg] = np.array([m.fit for m in rep.models])
            runs[f"{name} {alg}"] = dict(wall_s=time.perf_counter() - t0, mean_fit=float(fits[name, alg].mean()),
                                        unconverged_rows=unc.rows, rows=unc.total)
            print(f"{name} {alg}: {runs[f'{name} {alg}']}", flush=True)

    def gap(a, b):
        d = np.abs(a - b)
        part = np.nonzero(d > PART)[0]
        return dict(max=float(d.max()), parting_ids=[ids[i] for i in part], parting_ranks=ranks[part].tolist())

    gaps = {f"lawson_hanson vs bpp, {name}": gap(fits[name, "lawson_hanson"], fits[name, "bpp"]) for name in RUNS}
    gaps.update({f"float32 vs float64, {alg}": gap(fits["float32", alg], fits["float64", alg])
                 for alg in ("bpp", "lawson_hanson")})
    for k, v in gaps.items():
        print(f"{k}: max |fit diff| {v['max']:.3e}; above {PART}: ids {v['parting_ids']}, ranks "
              f"{v['parting_ranks']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "nnls_witness.json"), "w") as fh:
        json.dump(dict(device=args.device, ids=ids, ranks=ranks.tolist(), runs=runs, gaps=gaps,
                       fits={f"{a} {b}": v.tolist() for (a, b), v in fits.items()}), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
