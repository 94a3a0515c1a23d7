"""The benchmark of cp_cals_tpu_torch on one cell.

    python3 cals_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix, found by name under
``cals_bench/``. Earlier lines of standard output carry the run's
particulars (card, power limit and SM clock beside the window, kernel
build seconds, lookup-table decisions, every job's wall, peak allocated
bytes, every correctness reading); the last line is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and window seconds and the trace's
breakdown. The numbers the correctness check compares, each beside its
limit, close standard error and the result line (key ``checks``).

Exits 2 with no result without a CUDA card (or fewer than the cell asks
for), 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The lookup table read only: a missing entry would otherwise be timed and
# written into the package mid-run. (The program keeps its kernel builds
# inside the checkout itself: build/cuda/<digest>, build/native/<digest>.)
os.environ["CP_CALS_NO_AUTOTUNE"] = "1"
# One process with few threads: the host's share of a job is small-matrix
# work, and pools of worker threads only add jitter on a shared host.
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from cals_bench import runner
    from cals_bench.registry import Registry

    reg = Registry(ROOT)
    chips = reg.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", chips=chips, registry=reg,
                     t_process=T_PROCESS, log=lambda m: print(m, file=sys.stderr, flush=True))
    bad = runner.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    extra, result = out["extra"], out["result"]
    print(runner.dumps(dict(run=extra)), flush=True)
    (ROOT / "cals_bench" / "out").mkdir(exist_ok=True)
    name = f"{args.workload}.{args.seed}.{args.trace}.json"
    (ROOT / "cals_bench" / "out" / name).write_text(runner.dumps(out))
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(runner.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
