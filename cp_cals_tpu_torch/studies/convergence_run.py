"""Tol-driven convergence fidelity: float32 on the card against float64
(port of the JAX repo's ``scripts/convergence_run.py``).

A tolerance-driven (not forced) run reaches fits matched to the float64
oracle; the residual fit delta is set by the float32 MTTKRP and gramian
roundings, and at the bf16 MTTKRP tier by the stopping rule, which the
mixed-tier check (``--tol-check``, ``config.tol_check_interval``) makes
tol-safe.

Protocol: an EEM-shaped rank-5 tensor plus 5 % noise, models of ranks
3, 3, 5, 5, 7, 7 from shared host-side float64 inits, tol 1e-6, at most
500 iterations.

Run the float64 oracle first (on the card too: float64 takes the twostep
and the unfused epilogue), then the float32 run, which compares with it:
  python -m cp_cals_tpu_torch.studies.convergence_run --oracle
  python -m cp_cals_tpu_torch.studies.convergence_run [--mttkrp-precision default --tol-check 5 --polish 2 --tag mixed]
Writes convergence_{f64,<tag>}.json into ``--out`` (default
``chiprun_out/experiments``). The float32 run compares with the oracle in
``--out`` where there is one, else with the JAX package's committed
``data/benchmarks/convergence_f64.json`` (at the script's modes only); its
``oracle`` key says which.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import CalsParams
from ..device import resolve_device
from ..experiments import device_line
from ..ktensor import Ktensor, random_ktensor_host
from ..solvers import cp_cals
from ._common import OUT_DIR, load_json, oracle_source, write_json

MODES = (299, 301, 41)
RANKS = (3, 3, 5, 5, 7, 7)


def workload(modes=None, ranks=None):
    """The script's shared host float64 workload from ``default_rng(7)``
    (``modes`` and ``ranks`` default to MODES and RANKS): (tensor, queue of
    models of ``ranks``); each run casts to its dtype."""
    modes, ranks = modes or MODES, ranks or RANKS
    rng = np.random.default_rng(7)
    kt_true = random_ktensor_host(rng, modes, 5, dtype=np.float64)
    x64 = np.einsum("ir,jr,kr,r->ijk", *kt_true.factors, kt_true.lam)
    x64 = x64 + 0.05 * x64.std() * rng.standard_normal(x64.shape)
    queue64 = [random_ktensor_host(rng, modes, r, dtype=np.float64) for r in ranks]
    return x64, queue64


def params(tol=1e-6, max_iter=500, precision="highest", mttkrp_precision=None, polish=0, tol_check=0,
           **over) -> CalsParams:
    """The script's engine settings; ``over`` sets further fields (the
    phases that count kernel launches pin the MTTKRP method)."""
    return CalsParams(
        tol=tol,
        max_iterations=max_iter,
        bucket_ranks=(4, 8),
        precision=precision,
        mttkrp_precision=mttkrp_precision,
        polish_iters=polish,
        tol_check_interval=tol_check,
        sync_mode="evict",
        **over,
    )


def run(x64, queue64, p: CalsParams, dtype=torch.float32, device=None, warm=True):
    """One timed ``cp_cals`` of the workload at ``dtype`` (after an untimed
    one with ``warm``). Returns (results, report, wall seconds)."""
    dev = resolve_device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    x = torch.from_numpy(x64.astype(np_dtype)).to(dev)
    queue = [Ktensor(tuple(f.astype(np_dtype) for f in kt.factors), kt.lam.astype(np_dtype)) for kt in queue64]
    if warm:
        cp_cals(x, queue, p, device=dev)
    t0 = time.perf_counter()
    results, rep = cp_cals(x, queue, p, device=dev)
    return results, rep, time.perf_counter() - t0


def compare(models: list, oracle_models: list) -> dict:
    """The script's per-model deltas and ratios: each model of ``models``
    (dicts with id, iters, fit) that the oracle has gets
    ``fit_delta_vs_f64`` and ``iters_f64``; returns the max and mean
    |fit delta| and iteration ratio (None without a match)."""
    om = {m["id"]: m for m in oracle_models}
    deltas, ratios = [], []
    for m in models:
        o = om.get(m["id"])
        if o:
            m["fit_delta_vs_f64"] = m["fit"] - o["fit"]
            m["iters_f64"] = o["iters"]
            deltas.append(abs(m["fit_delta_vs_f64"]))
            ratios.append(m["iters"] / max(o["iters"], 1))
    return {
        "max_abs_fit_delta": max(deltas) if deltas else None,
        "mean_abs_fit_delta": sum(deltas) / len(deltas) if deltas else None,
        "max_iters_ratio_vs_f64": max(ratios) if ratios else None,
        "mean_iters_ratio_vs_f64": sum(ratios) / len(ratios) if ratios else None,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--oracle", action="store_true", help="run the float64 oracle instead of the float32 run")
    p.add_argument("--modes", default="299-301-41")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-iter", type=int, default=500)
    p.add_argument("--precision", default="highest")
    p.add_argument("--mttkrp-precision", default=None, help="MTTKRP-only precision tier override")
    p.add_argument("--polish", type=int, default=0,
                   help="polish_iters: full-precision refinement sweeps for converged models")
    p.add_argument("--tol-check", type=int, default=0,
                   help="tol_check_interval: mixed-tier stopping, the stop evaluated every K iterations from a "
                        "full-precision last-mode MTTKRP (makes the bf16 tier tol-safe)")
    p.add_argument("--tag", default=None, help="output suffix (default: f64 for the oracle, else cuda)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.modes.split("-"))
    dtype = torch.float64 if args.oracle else torch.float32
    x64, queue64 = workload(modes)
    cp = params(args.tol, args.max_iter, args.precision, args.mttkrp_precision, args.polish, args.tol_check)
    _, rep, wall = run(x64, queue64, cp, dtype, dev)

    tag = args.tag or ("f64" if args.oracle else "cuda")
    out = {
        "device": device_line(dev),
        "dtype": str(dtype).removeprefix("torch."),
        "precision": args.precision,
        "mttkrp_precision": args.mttkrp_precision,
        "polish_iters": args.polish,
        "tol_check_interval": args.tol_check,
        "tol": args.tol,
        "wall_s": wall,
        "models": [
            {"id": m.id, "rank": m.rank, "iters": m.iters, "fit": float(m.fit), "error": float(m.approx_error)}
            for m in rep.models
        ],
    }
    if not args.oracle:
        src = oracle_source("convergence_f64.json", args.out, committed=modes == MODES)
        if src:
            out["oracle"] = src
            out.update(compare(out["models"], load_json(src)["models"]))
    write_json(args.out, f"convergence_{tag}.json", out)
    print(json.dumps({k: v for k, v in out.items() if k != "models"}))
    for m in out["models"]:
        print(m)
    return out


if __name__ == "__main__":
    main()
