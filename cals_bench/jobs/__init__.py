"""Job kinds, one module each, found by the traffic's ``job`` name
(``jobs/<job>.py``, which defines ``Job``).

A ``Job`` is made once per run from the configuration, the traffic mix,
the seed and the device, and holds the inputs it hands the program.
``Job.run()`` is one call of the program's entry, timed from the call
until its results are on the host, and returns an ``Out``, of which the
window keeps a ``runner.JobRecord``. After the window, ``Job.work(rec)``
counts a job's useful work, ``Job.answers(rec, full)`` takes what the
correctness check judges (``full``: the models themselves too, for the
sampled jobs), ``Job.reference()`` computes the plain reference once (the
jobs of one run all take the same inputs), ``Job.readings(answers, ref)``
the numbers compared, and ``Job.control_answers()`` the precision
control's answers where the control is the reference in a lower precision.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any


@dataclass
class Out:
    report: Any  # the engine's CalsReport
    results: Any  # the fitted models (select) or replicates (jackknife)
    n_models: int
    solver_s: float | None = None  # JKReport.solver_time
    pre_s: float | None = None  # JKReport.pre_time


def job_class(kind: str):
    return importlib.import_module(f"{__name__}.{kind}").Job
