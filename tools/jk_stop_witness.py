#!/usr/bin/env python3
"""Where the jackknife's tol-driven stops come from: the apply kernel against
its plain version on the card, and against float64 on the CPU.

    python3 tools/jk_stop_witness.py [--out DIR]

The jackknife configuration of chip_smoke.py (the bench tensor's rank-5
model, 299 leave-one-out replicates in one bucket of rank 8, tol 1e-6,
"high" tier) runs through jk_cp_cals on the card twice per setting: with
the fused epilogue's apply kernel ("kernel") and with the apply's plain
PyTorch version on the card in its place ("plain"; the iteration's
``epilogue_apply`` swapped for ``epilogue_apply_plain``, everything else
unchanged). Settings: the tol-driven run, and runs forced to 1..K_MAX
iterations, whose per-replicate fits give each iteration's fit change. The
same 10 fibers as chip_smoke's cross-check also run in float64 on the CPU,
tol-driven and forced, for the stops the fit's fp32 rounding does not move.

Prints, per version, the mean iterations, the histogram of iteration counts,
the per-replicate fit difference kernel - plain (tol-driven and at each
forced count), and at each iteration how many replicates change their fit
by less than tol; writes everything to DIR/jk_stop_witness.json (default
chiprun_out/). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the jackknife configuration and its model)

K_MAX = 5
TOL = 1e-6


class PlainApply:
    """Within the block, the iteration calls the apply's plain version."""

    def __enter__(self):
        from cp_cals_tpu_torch.ops import fused_epilogue as fe
        from cp_cals_tpu_torch.solvers import iteration

        self.module, self.real = iteration, iteration.epilogue_apply
        iteration.epilogue_apply = fe.epilogue_apply_plain
        return self

    def __exit__(self, *exc):
        self.module.epilogue_apply = self.real


def run(x_np, kt5, plain: bool, **kw):
    """Per-replicate (fits, iterations) of one jk_cp_cals run on the card,
    and the apply kernel's launches in it."""
    from cp_cals_tpu_torch import jk_cp_cals
    from cp_cals_tpu_torch.ops import fused_epilogue as fe

    fe.epilogue_apply.launches = 0
    if plain:
        with PlainApply():
            rep = jk_cp_cals(x_np, [kt5], chip_smoke.jk_params(**kw))
    else:
        rep = jk_cp_cals(x_np, [kt5], chip_smoke.jk_params(**kw))
    torch.cuda.synchronize()
    models = rep.cals_report.models
    return (np.array([m.fit for m in models], np.float64), np.array([m.iters for m in models]),
            fe.epilogue_apply.launches)


def cpu64(x_np, kt5, fibers, **kw):
    """Per-fiber (fits, iterations) of the float64 CPU run of ``fibers``."""
    from cp_cals_tpu_torch import Ktensor, cp_cals
    from cp_cals_tpu_torch.solvers.jackknife import to_host_model

    ref = to_host_model(Ktensor(tuple(f.astype(np.float64) for f in kt5.factors), kt5.lam.astype(np.float64)))
    p = chip_smoke.jk_params(precision="highest", result_wire_dtype=None, **kw)
    _, rep = cp_cals(x_np.astype(np.float64), [ref] * len(fibers), p, jk_fibers=fibers, device="cpu")
    return np.array([m.fit for m in rep.models]), np.array([m.iters for m in rep.models])


def stats(d: np.ndarray) -> dict:
    return dict(mean=float(d.mean()), mean_abs=float(np.abs(d).mean()), max_abs=float(np.abs(d).max()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("jk_stop_witness: CUDA is not available", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    x_np, _ = chip_smoke.bench_tensor()
    kt5, _ = chip_smoke.fit_jk_model(x_np)
    fibers = [int(f) for f in np.linspace(0, chip_smoke.MODES[0] - 1, 10).round()]
    out = dict(card=chip_smoke.card_line(), tol=TOL, fibers=fibers, versions={})

    tol_runs, forced = {}, {}
    for name, plain in (("kernel", False), ("plain", True)):
        fits, iters, launches = run(x_np, kt5, plain)
        if (launches == 0) != plain:
            raise AssertionError(f"{name}: the apply kernel launched {launches} times")
        tol_runs[name] = (fits, iters)
        forced[name] = [run(x_np, kt5, plain, force_max_iter=True, max_iterations=k)[0]
                        for k in range(1, K_MAX + 1)]
    f64, i64 = cpu64(x_np, kt5, fibers)
    f64_forced = [cpu64(x_np, kt5, fibers, force_max_iter=True, max_iterations=k)[0]
                  for k in range(1, K_MAX + 1)]

    for name, (fits, iters) in tol_runs.items():
        fk = forced[name]
        # |fit_k - fit_{k-1}| < tol: the replicates that stop at iteration k
        # if they get there (the fit before iteration 1 is 0).
        small = [int((np.abs(fk[k] - fk[k - 1]) < TOL).sum()) for k in range(1, K_MAX)]
        out["versions"][name] = dict(
            mean_iters=float(iters.mean()),
            iters_histogram={int(k): int(v) for k, v in sorted(collections.Counter(iters.tolist()).items())},
            iters_at_fibers=iters[fibers].tolist(),
            below_tol_at_iteration={k + 1: small[k - 1] for k in range(1, K_MAX)},
        )
        print(f"{name}: mean iters {iters.mean():.3f}, histogram "
              f"{out['versions'][name]['iters_histogram']}, |dfit| < tol at iterations 2..{K_MAX}: {small}, "
              f"iterations at the 10 fibers {iters[fibers].tolist()}", flush=True)
    small64 = [int((np.abs(f64_forced[k] - f64_forced[k - 1]) < TOL).sum()) for k in range(1, K_MAX)]
    out["versions"]["cpu_float64_10_fibers"] = dict(
        mean_iters=float(i64.mean()), iters_at_fibers=i64.tolist(),
        below_tol_at_iteration={k + 1: small64[k - 1] for k in range(1, K_MAX)})
    print(f"cpu float64 (10 fibers): mean iters {i64.mean():.3f}, iterations {i64.tolist()}, "
          f"|dfit| < tol at iterations 2..{K_MAX}: {small64}", flush=True)

    # Per-replicate fit differences, kernel - plain, and each against float64.
    diffs = dict(tol_driven=stats(tol_runs["kernel"][0] - tol_runs["plain"][0]))
    for k in range(1, K_MAX + 1):
        kern, pl, ref = forced["kernel"][k - 1], forced["plain"][k - 1], f64_forced[k - 1]
        diffs[f"forced_{k}"] = dict(
            kernel_minus_plain=stats(kern - pl),
            kernel_minus_float64=stats(kern[fibers] - ref), plain_minus_float64=stats(pl[fibers] - ref),
            # the fit change of iteration k, each version against float64's
            dfit_kernel_minus_float64=None if k == 1 else stats(
                (kern - forced["kernel"][k - 2])[fibers] - (ref - f64_forced[k - 2])),
            dfit_plain_minus_float64=None if k == 1 else stats(
                (pl - forced["plain"][k - 2])[fibers] - (ref - f64_forced[k - 2])),
        )
    out["fit_differences"] = diffs
    for key, d in diffs.items():
        print(f"fit difference {key}: {json.dumps(d)}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "jk_stop_witness.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
