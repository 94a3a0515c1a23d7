"""Result-CSV readers and speedup summaries (port of
``cp_cals_tpu/utils/analysis.py``): read the per-model result CSVs the
solvers write (KTENSOR_ID;RANK;ERROR;ITERS) and the iteration traces,
summarize them, and gather the headline numbers of the benchmark JSON
files (``benchmark_dashboard``). Plotting is left to the caller.

    python -m cp_cals_tpu_torch.utils.analysis   # the dashboard as JSON
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass

# Where the port's experiment harness writes (``experiments.py --out``'s
# default, git-ignored): the dashboard's default directory. The JAX
# package's ``data/benchmarks/`` holds a TPU's numbers and is never read
# by default.
DEFAULT_BENCH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "chiprun_out", "experiments"
)


@dataclass
class ModelRow:
    id: int
    rank: int
    error: float
    iters: int


def read_results_csv(path: str) -> list[ModelRow]:
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter=";"):
            out.append(
                ModelRow(
                    id=int(row["KTENSOR_ID"]),
                    rank=int(row["RANK"]),
                    error=float(row["ERROR"]),
                    iters=int(row["ITERS"]),
                )
            )
    return out


def read_trace_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return [dict(row) for row in csv.DictReader(f, delimiter=";")]


def summarize(rows: list[ModelRow]) -> dict:
    n = len(rows)
    by_rank: dict[int, list[ModelRow]] = {}
    for r in rows:
        by_rank.setdefault(r.rank, []).append(r)
    return {
        "n_models": n,
        "total_iters": sum(r.iters for r in rows),
        "mean_iters": sum(r.iters for r in rows) / max(n, 1),
        "best_error_by_rank": {
            k: min(r.error for r in v) for k, v in sorted(by_rank.items())
        },
    }


def speedup(time_baseline_s: float, time_s: float) -> float:
    return time_baseline_s / time_s


def benchmark_dashboard(bench_dir: str | None = None) -> dict:
    """The headline numbers of every benchmark JSON file in ``bench_dir``
    (default ``DEFAULT_BENCH_DIR``), by the JAX package's file names and
    keys (``cp_cals_tpu/utils/analysis.py:benchmark_dashboard``). Returns
    {artifact: headline metrics}; absent files are skipped."""
    if bench_dir is None:
        bench_dir = DEFAULT_BENCH_DIR

    def load(name):
        p = os.path.join(bench_dir, name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    out: dict = {}
    if (d := load("bench_tol_measured.json")) is not None:
        out["tol_leg"] = {
            "models_per_sec": d.get("models_per_sec"),
            "iters_ratio_vs_f64": d.get("mean_iters_ratio_vs_f64"),
            "median_fit_delta_vs_f64": d.get("median_abs_fit_delta_vs_f64"),
        }
    if (d := load("bench_jk_measured.json")) is not None:
        out["jackknife"] = {
            "replicates_per_sec": d.get("jk_replicates_per_sec"),
            "tier": d.get("jk_tier"),
        }
    if (d := load("jk_fp32_vs_fp64.json")) is not None:
        out["jk_se_fidelity_p99"] = {
            tag: [round(r["dtype_err_over_scatter_p99"], 2) for r in rows]
            for tag, rows in d.get("tiers", {}).items()
        }
    if (d := load("scale_sweep_layout_policy.json")) is not None:
        out["scale_500"] = {
            k: {"models_per_sec": v.get("models_per_sec"), "mttkrp_tflops": v.get("mttkrp_tflops")}
            for k, v in d.items()
            if isinstance(v, dict) and "models_per_sec" in v
        }
    if (d := load("external_cpd.json")) is not None:
        out["external_cross_check"] = {
            **{k: v.get("models_per_sec") for k, v in d.get("contenders", {}).items()},
            "max_fit_diff": max(d.get("cross_check", {}).values(), default=None),
        }
    if (d := load("experiments.json")) is not None:
        out["grid_6_1_speedup_vs_batched_als"] = {
            k: round(v["speedup"], 2)
            for k, v in d.items()
            if isinstance(v, dict) and "speedup" in v
        }
    return out


if __name__ == "__main__":
    print(json.dumps(benchmark_dashboard(), indent=1))
