"""Result-CSV readers and speedup summaries (port of
``cp_cals_tpu/utils/analysis.py``): read the per-model result CSVs the
solvers write (KTENSOR_ID;RANK;ERROR;ITERS) and the iteration traces, and
summarize them. Plotting is left to the caller.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass


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
