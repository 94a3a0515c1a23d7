"""The readings that a cell's correctness limits are set from: the
program's on many seeds, its precision control's and each planted fault's
on a few, at the cell's own size, in one process, each judged by the
cell's limits as a run judges its own.

    python3 cals_bench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3
        [--faults state_unchanged,half_the_batch,answer_altered --fault-seeds 1] [--jobs 2]

For each seed the program runs the cell's job ``--jobs`` times after one
warm-up (every job's answers taken in full) and the check's numbers are
read against the reference, as a run reads them after its window, then
judged (``runner.judge``) against ``limits/<cell>.json``. The control is
the traffic's ``control``: the program with the lower-precision settings
of ``override`` switched on (``"kind": "program"``), or the reference
itself in the program's place with every product's operands rounded to
TF32 (``"kind": "reference"``, for a configuration that states float32
with TF32 off). A fault (``faults.py``) is planted in the program for its
seeds. The benchmark's own runs never run either. Prints one JSON line per
seed and side (its readings, checks and ``correct``), then per number the
largest program reading (``lower``) and the smallest control reading
(``upper``), and whether every program seed read correct and every
control and fault seed not. ``--device cpu`` runs the program's plain
versions (for the tests, at a size they can hold).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["CP_CALS_NO_AUTOTUNE"] = "1"
sys.path.insert(0, str(ROOT))


def program_readings(job, n_jobs: int) -> dict:
    from cals_bench.runner import record_of

    job.run()  # warm-up
    answers = [job.answers(record_of(job.run(), 0.0, 0.0), full=True) for _ in range(n_jobs)]
    return job.readings(answers, job.reference())


def control_readings(job_cls, cfg, traffic, seed, device, n_jobs: int) -> dict:
    from cals_bench.reference import als

    ctl = traffic["control"]
    if ctl["kind"] == "program":
        return program_readings(job_cls(cfg, traffic, seed, device, ctl["override"]), n_jobs)
    job = job_cls(cfg, traffic, seed, device)
    ans = job.control_answers(als.tf32 if ctl.get("tf32") else None)
    return job.readings([ans], job.reference())


def seeds_of(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None, registry=None, out=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from cals_bench import faults, runner
    from cals_bench.jobs import job_class
    from cals_bench.registry import Registry

    reg = registry or Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(args.workload)
    job_cls = job_class(traffic["job"])
    runs = [("program", s) for s in seeds_of(args.seeds)] + [("control", s) for s in seeds_of(args.control_seeds)]
    runs += [(f"fault:{f}", s) for f in args.faults.split(",") if f for s in seeds_of(args.fault_seeds)]
    sides: dict[str, list] = {}
    for side, seed in runs:
        t0 = time.perf_counter()
        if side == "program":
            r = program_readings(job_cls(cfg, traffic, seed, args.device), args.jobs)
        elif side == "control":
            r = control_readings(job_cls, cfg, traffic, seed, args.device, args.jobs)
        else:
            with faults.planted(side.split(":", 1)[1]):
                r = program_readings(job_cls(cfg, traffic, seed, args.device), args.jobs)
        checks, correct = runner.judge(r, limits)
        sides.setdefault(side, []).append((r, correct))
        out(json.dumps(dict(side=side, seed=seed, seconds=time.perf_counter() - t0, correct=correct, checks=checks,
                            readings=r)))
    program, control = sides.get("program", []), sides.get("control", [])
    summary = {name: dict(lower=max(r[name] for r, _ in program), upper=min((r[name] for r, _ in control), default=None))
               for name in (program[0][0] if program else [])}
    verdicts = {side: [c for _, c in got] for side, got in sides.items()}
    sound = all(verdicts.get("program", [])) and not any(c for side, cs in verdicts.items() if side != "program"
                                                         for c in cs)
    out(json.dumps(dict(workload=args.workload, summary=summary, correct=verdicts, sound=sound)))
    return dict(summary=summary, correct=verdicts, sound=sound)


if __name__ == "__main__":
    main()
