"""Tol-driven throughput: the reference's real-tensor protocol (port of the
JAX repo's ``scripts/bench_tol.py``).

The headline bench runs the paper's forced-iteration protocol (50
iterations a model). The reference's real-tensor experiments are
tol-driven (tol 1e-6, at most 1000 iterations, experiments.cpp:100-150;
default tol include/cals.h:150): this study measures models/s under that
stopping rule on the same EEM workload (299x301x41, 20 models of each rank
1-20 from ``RandomKtensorSpec`` seeds ``1000 * r + c``), with the
mixed-tier check (``--tol-check``) keeping the bf16 MTTKRP tier tol-safe.

Two runs, matched at the stopping rule, both on the card unless
``--device cpu`` is given:
  python -m cp_cals_tpu_torch.studies.bench_tol --oracle   # float64, plain per-iteration stop
  python -m cp_cals_tpu_torch.studies.bench_tol            # float32, bf16 tier + K=5 checks

The oracle writes ``bench_tol_f64.json`` into ``--out`` (default
``chiprun_out/experiments``). The card leg compares with that file where it
is there, else with the JAX package's committed
``data/benchmarks/bench_tol_f64.json`` (its ``oracle`` key says which), and
reports per-model fit deltas, iteration ratios and ``vs_baseline``, where
the baseline is credited with the float64 iteration counts: (sum over the
models of the oracle's iterations x the FLOPs of an iteration at the
model's rank) / the 32-core CPU rate. It writes ``bench_tol_measured.json``.

Environment, as the script reads it: ``BENCH_BUFFER`` (buffer_size, 2880),
``BENCH_THREADS`` (bucket_threads; 1, the port's default, where the JAX
script's is 4: threads measured slower on the H100), ``BENCH_WIRE`` (the
result wire dtype, float16; empty for none).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import CalsParams
from ..device import resolve_device
from ..experiments import device_line
from ..ktensor import Ktensor, RandomKtensorSpec, spec_to_ktensor
from ..ops.mttkrp import als_iteration_flops
from ..solvers import cp_cals
from ._common import BASELINE_CPU_FLOPS, OUT_DIR, bench_tensor, best_of, load_json, oracle_source, write_json

MODES = (299, 301, 41)
RANKS = range(1, 21)
COPIES = 20


def workload(modes=None, ranks=None, copies: int | None = None):
    """The bench tensor from ``default_rng(42)`` (host float64: a float32
    rank-5 model plus 5 % noise) and the spec queue (``modes``, ``ranks``
    and ``copies`` default to MODES, RANKS and COPIES)."""
    modes, ranks, copies = modes or MODES, ranks or RANKS, copies or COPIES
    x_np = bench_tensor(np.random.default_rng(42), modes)
    specs = [RandomKtensorSpec(tuple(modes), r, seed=1000 * r + c, dtype="float32") for r in ranks for c in range(copies)]
    return x_np, specs


def oracle_queue(specs, device=None) -> list:
    """The specs' float32 inits (the card leg's device-generated ones, bit
    for bit), cast to float64, on the host."""
    out = []
    for s in specs:
        kt = spec_to_ktensor(s, device)
        out.append(Ktensor(tuple(f.double().cpu().numpy() for f in kt.factors), kt.lam.double().cpu().numpy()))
    return out


def oracle_params(tol=1e-6, max_iter=1000, **over) -> CalsParams:
    return CalsParams(tol=tol, max_iterations=max_iter, bucket_ranks=(4, 8, 16, 20), buffer_size=2880,
                      sync_mode="evict", tail_compaction_depth=2, **over)


def card_params(tol=1e-6, max_iter=1000, tol_check=5, polish=2, polish_tol=0.0, mttkrp_tier="default",
                precision="high", evict_batch=1, environ=os.environ, **over) -> CalsParams:
    """The card leg's settings (``over`` sets further fields: the phases
    that count kernel launches pin the MTTKRP method)."""
    return CalsParams(
        tol=tol,
        max_iterations=max_iter,
        # bench.py's grid: bucketing is trajectory-invariant (CALS == ALS),
        # so the float64 oracle's per-model iterations and fits still apply.
        bucket_ranks=(4, 8, 12, 16, 20),
        buffer_size=int(environ.get("BENCH_BUFFER", "2880")),
        bucket_threads=int(environ.get("BENCH_THREADS", "1")),
        precision=precision,
        mttkrp_precision=mttkrp_tier or None,
        tol_check_interval=tol_check,
        polish_iters=polish,
        polish_tol=polish_tol,
        evict_batch=evict_batch,
        # Fits and iterations are computed on the device before the cast,
        # so no fidelity column is affected by the half-width wire.
        result_wire_dtype=environ.get("BENCH_WIRE", "float16") or None,
        sync_mode="evict",
        tail_compaction_depth=2,
        **over,
    )


def compare(models: list, oracle_models: list, modes, wall: float) -> dict:
    """The script's summary of the card leg's ``models`` (dicts with id,
    rank, fit, iters) against the oracle's: the |fit delta| statistics,
    iteration ratios, the eight worst models, and, where the oracle covers
    every model, the baseline's wall at the same stopping rule and
    ``vs_baseline``."""
    n_models = len(models)
    out = {}
    om = {m["id"]: m for m in oracle_models}
    deltas, ratios, o_flops, worst = [], [], 0.0, []
    for m in models:
        o = om.get(m["id"])
        if not o:
            continue
        d = abs(m["fit"] - o["fit"])
        deltas.append(d)
        worst.append({"id": m["id"], "rank": m["rank"], "fit": float(m["fit"]), "fit_f64": o["fit"],
                      "iters": m["iters"], "iters_f64": o["iters"], "delta": d})
        ratios.append(m["iters"] / max(o["iters"], 1))
        o_flops += o["iters"] * als_iteration_flops(modes, o["rank"])
    if deltas:
        ds = sorted(deltas)
        out["max_abs_fit_delta_vs_f64"] = max(deltas)
        out["mean_abs_fit_delta_vs_f64"] = sum(deltas) / len(deltas)
        out["median_abs_fit_delta_vs_f64"] = ds[len(ds) // 2]
        out["p99_abs_fit_delta_vs_f64"] = ds[int(len(ds) * 0.99)]
        out["n_delta_gt_1e-2"] = sum(d > 1e-2 for d in deltas)
        out["mean_iters_ratio_vs_f64"] = sum(ratios) / len(ratios)
        out["max_iters_ratio_vs_f64"] = max(ratios)
        out["worst_models"] = sorted(worst, key=lambda w: -w["delta"])[:8]
        if len(deltas) == n_models:
            # The 32-core reference machine credited with the float64
            # oracle's per-model iteration counts at its modelled rate.
            base_wall = o_flops / BASELINE_CPU_FLOPS
            out["baseline_wall_s_same_rule"] = base_wall
            out["vs_baseline"] = base_wall / wall
        else:
            out["oracle_coverage"] = f"{len(deltas)}/{n_models}"
    return out


def run_oracle(x_np, specs, p: CalsParams, device=None) -> dict:
    """The float64 leg: the oracle's output (models with id, rank, iters,
    fit) and, under "report", the engine report."""
    dev = resolve_device(device)
    queue = oracle_queue(specs, dev)
    x = torch.from_numpy(x_np.astype(np.float64)).to(dev)
    t0 = time.perf_counter()
    _, rep = cp_cals(x, queue, p, device=dev)
    wall = time.perf_counter() - t0
    return {
        "device": device_line(dev), "dtype": "float64", "tol": p.tol, "max_iter": p.max_iterations,
        "wall_s": wall,
        "models": [{"id": m.id, "rank": m.rank, "iters": m.iters, "fit": float(m.fit)} for m in rep.models],
        "report": rep,
    }


def run_card(x_np, specs, p: CalsParams, reps: int = 3, device=None, warm: bool = True) -> tuple:
    """The float32 leg (``_common.best_of``): (results, report, best wall)."""
    dev = resolve_device(device)
    return best_of(torch.from_numpy(x_np.astype(np.float32)).to(dev), specs, p, dev, reps, warm)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--oracle", action="store_true")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-iter", type=int, default=1000)
    p.add_argument("--tol-check", type=int, default=5)
    p.add_argument("--polish", type=int, default=2)
    p.add_argument("--polish-tol", type=float, default=0.0,
                   help="config.polish_tol: polish converged models to convergence at full precision "
                        "(--polish becomes the sweep cap)")
    p.add_argument("--copies", type=int, default=None, help="models per rank (default: 20, the bench workload)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--mttkrp-tier", default="default",
                   help="MTTKRP precision tier of the card leg: 'default' (bf16, needs --tol-check > 0), "
                        "'high' (bf16 hi/lo; plain stop works), or '' to inherit --precision")
    p.add_argument("--precision", default="high")
    p.add_argument("--evict-batch", type=int, default=1,
                   help="config.evict_batch: defer the host eviction sync until this many models have converged")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    copies = args.copies if args.copies is not None else COPIES
    x_np, specs = workload(copies=copies)
    modes = tuple(x_np.shape)

    if args.oracle:
        out = run_oracle(x_np, specs, oracle_params(args.tol, args.max_iter), dev)
        out.pop("report")
        out["copies"] = copies
        write_json(args.out, "bench_tol_f64.json", out)
        print(json.dumps({k: v for k, v in out.items() if k != "models"}))
        return out

    params = card_params(args.tol, args.max_iter, args.tol_check, args.polish, args.polish_tol, args.mttkrp_tier,
                         args.precision, args.evict_batch)
    _, rep, wall = run_card(x_np, specs, params, args.reps, dev)
    n_models = len(specs)
    out = {
        "device": device_line(dev), "dtype": "float32",
        "protocol": "tol-driven (reference experiments.cpp:100-150)",
        "tol": args.tol, "max_iter": args.max_iter,
        "tol_check_interval": args.tol_check, "polish_iters": args.polish,
        "polish_tol": args.polish_tol,
        "evict_batch": args.evict_batch,
        "bucket_threads": params.bucket_threads,
        "result_wire_dtype": params.result_wire_dtype,
        "mttkrp_precision": args.mttkrp_tier or None,
        "precision": args.precision,
        "copies": copies,
        "wall_s": wall,
        "models_per_sec": n_models / wall,
        "mean_fit": sum(m.fit for m in rep.models) / n_models,
        "mean_iters": sum(m.iters for m in rep.models) / n_models,
        "n_max_iter_capped": sum(m.iters >= args.max_iter for m in rep.models),
    }
    src = oracle_source("bench_tol_f64.json", args.out)
    out["oracle"] = src
    models = [{"id": m.id, "rank": m.rank, "fit": m.fit, "iters": m.iters} for m in rep.models]
    out.update(compare(models, load_json(src)["models"], modes, wall))
    write_json(args.out, "bench_tol_measured.json", out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
