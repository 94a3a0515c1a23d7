"""Phase timers, the per-iteration trace and the CSV reports (port of
``cp_cals_tpu/utils/timers.py``).

The reference's timer taxonomy and CSV writers: host wall clocks around
phases, and analytic FLOP counts per iteration (``ops/mttkrp.py``). A
traced engine run takes one ``IterationRecord`` per engine iteration;
kernel-level profiles come from ``torch.profiler``
(``tools/profile_engine.py``).
"""

from __future__ import annotations

import csv
import dataclasses
import time
from collections import defaultdict
from dataclasses import dataclass, field


class Timer:
    """Accumulating wall-clock timer."""

    def __init__(self) -> None:
        self.t = 0.0
        self._start = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._start
        self.t += dt
        return dt

    def get_time(self) -> float:
        return self.t


@dataclass
class IterationRecord:
    iteration: int
    active_models: int
    active_columns: int
    flops: int
    wall_s: float
    bucket: int = 0  # the bucket rank the record belongs to


@dataclass
class RunTrace:
    """Per-iteration trace: live models, live true-rank columns, FLOPs at
    those columns, and wall time, per engine iteration of each bucket."""

    records: list = field(default_factory=list)
    phase_totals: dict = field(default_factory=lambda: defaultdict(float))

    def add(self, rec: IterationRecord) -> None:
        self.records.append(rec)

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, delimiter=";")
            w.writerow(["ITER", "MODELS", "COLS", "FLOPS", "TIME", "BUCKET"])
            for r in self.records:
                w.writerow(
                    [r.iteration, r.active_models, r.active_columns, r.flops,
                     f"{r.wall_s:.9f}", r.bucket]
                )

    @property
    def total_time(self) -> float:
        return sum(r.wall_s for r in self.records)

    @property
    def total_flops(self) -> int:
        return sum(r.flops for r in self.records)


def write_cals_report_csv(path: str, report, params=None) -> None:
    """The run report with its configuration: a commented header of the
    solver parameters and the report's totals, then one row per model."""
    with open(path, "w", newline="") as f:
        if params is not None:
            for field_ in dataclasses.fields(params):
                v = getattr(params, field_.name)
                v = getattr(v, "value", v)
                f.write(f"# {field_.name}={v}\n")
        f.write(f"# n_ktensors={report.n_ktensors}\n")
        f.write(f"# ktensor_comp_sum={report.ktensor_comp_sum}\n")
        for r, pt in getattr(report, "phase_times", {}).items():
            pretty = ",".join(f"{k}={v:.4f}" for k, v in pt.items())
            f.write(f"# bucket_{r}_times={pretty}\n")
        w = csv.writer(f, delimiter=";")
        w.writerow(["KTENSOR_ID", "RANK", "ERROR", "FIT", "ITERS"])
        for m in report.models:
            w.writerow(
                [m.id, m.rank, f"{m.approx_error:.17g}", f"{m.fit:.17g}",
                 m.iters]
            )


def write_ktensor_results_csv(path: str, model_reports) -> None:
    """id;rank;error;iters per model."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["KTENSOR_ID", "RANK", "ERROR", "ITERS"])
        for m in model_reports:
            w.writerow([m.id, m.rank, f"{m.approx_error:.17g}", m.iters])
