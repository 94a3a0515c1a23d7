#!/usr/bin/env python3
"""The 500^3 layout-policy A/B: ``experiments.scale_sweep`` under
``mode_layouts="materialized"`` (every mode's layout of X held for the
run) against ``"recompute"`` (each layout derived inside the iteration), in
turns within one process (ABAB for ``--turns 2``).

    python3 tools/layout_policy_ab.py [--modes 500-500-500] [--copies 250]
        [--max-iter 50] [--turns 2] [--device cuda|cpu]
        [--out chiprun_out/experiments]

The defaults are the sweep's own (500^3 float32, ranks 1-20 x 250 copies =
5,000 models, 50 forced iterations, the engine settings of
``experiments.SWEEP_SETTINGS``: "high", buckets 4/8/16/20, a 3,840-column
budget); ``--copies`` and ``--max-iter`` cut it.

Before the runs the bytes are reckoned (``hbm_reckoned``): X, and under
"materialized" each layout held, one per (mode, method, tier) that some
bucket's picks need, over the waves that ``profiles/tune_lut_grid.
allocations`` lists for the sweep's queue (the fused kernels' bf16 hi/lo planes at "high", with
k padded; X's size for the twostep and krp_gemm); under "recompute" the
largest layout one derivation makes. On the card the run's measured peak
of allocated bytes (``hbm_measured``) stands beside it.

The two policies' last runs are held to each other: every model's
iteration count equal, every fit within ``FIT_BAND``. The band is 0
(bit for bit): both policies compute each layout with the same operations,
once held and once in the loop, and on the CPU in float32 at "high"
(30x25x20, 60 models, 10 iterations) and float64 the fits and factors of
the two were equal bit for bit; ``chip_smoke.py`` holds recompute to
materialized bit for bit at the bench tiers as well. On the card every
table decision must be exact (``lut_dispatch``: no nearest, no heuristic).

Writes ``scale_sweep_layout_policy.json`` into ``--out``: one entry per
policy with the JAX file's keys (``models_per_sec``, ``mttkrp_tflops``,
``hbm_model_bytes``, ``mode_layouts_resolved``, ``lut_dispatch``,
``warmup_s``, ``wall_s``, ...) of the policy's fastest turn, plus
``hbm_measured`` (card only), ``hbm_reckoned``, and every turn's
``walls_s`` and ``warmups_s`` in run order (the bench-tier wall spreads
between calls, so only turns within one call compare), and ``card`` and
``checks`` at the top.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cp_cals_tpu_torch import experiments  # noqa: E402
from cp_cals_tpu_torch.device import resolve_device  # noqa: E402
from cp_cals_tpu_torch.ops.fused_mttkrp import held_nbytes  # noqa: E402
from cp_cals_tpu_torch.ops.mttkrp import resolve_batched_method  # noqa: E402
from cp_cals_tpu_torch.profiles.tune_lut_grid import allocations  # noqa: E402
from cp_cals_tpu_torch.utils import lut  # noqa: E402

POLICIES = ("materialized", "recompute")
FIT_BAND = 0.0  # |fit - fit of the first run|, every model (module docstring)


def layout_bytes(shape, mode: int, method: str, tier: str, itemsize: int) -> int:
    """Bytes of one mode's layout of X for ``method`` (``ops/mttkrp.py:
    prepare_mode``)."""
    if method != "pallas":
        return int(np.prod(shape)) * itemsize
    return held_nbytes(shape, mode, tier, itemsize)


def reckon(modes, copies: int, dtype, dev) -> dict:
    """The bytes each policy should hold (module docstring), from the picks
    of every bucket the sweep allocates."""
    sweep = experiments.SWEEP_SETTINGS
    tier = sweep["precision"]
    itemsize = torch.empty((), dtype=dtype).element_size()
    layouts = {}
    for wave in allocations(f"1:{sweep['rank_max']}:{copies}", sweep["bucket_ranks"], sweep["buffer_size"]):
        for r, b in wave.items():
            picks = lut.lookup_methods(tuple(modes), r, b, tier, dtype, dev)
            for n, m in enumerate(picks):
                m = resolve_batched_method(m, modes, n, dtype, dev, b, r)
                layouts[f"mode {n} {m}"] = layout_bytes(modes, n, m, tier, itemsize)
    lut.reset_lookup_stats()
    x_bytes = int(np.prod(modes)) * itemsize
    return {
        "materialized": {"tensor": x_bytes, "held_layouts": sum(layouts.values()), "layouts": layouts},
        "recompute": {"tensor": x_bytes, "held_layouts": 0, "largest_derived_layout": max(layouts.values())},
    }


def ab(modes=(500, 500, 500), copies: int = 250, max_iter: int = 50, turns: int = 2, dtype=torch.float32,
       device=None) -> tuple[dict, dict]:
    """The A/B (module docstring): (the file's dict, {policy: (results,
    report) of its last run}). On the card a table decision that is not
    exact fails the run."""
    dev = resolve_device(device)
    reckoned = reckon(modes, copies, dtype, dev)
    out = {"card": experiments.device_line(dev), "modes": list(modes), "copies": copies, "max_iter": max_iter,
           "turns": turns, "fit_band": FIT_BAND}
    runs = {p: [] for p in POLICIES}
    last = {}
    for turn in range(turns):
        for policy in POLICIES:
            res, results, rep = experiments.scale_sweep(modes=tuple(modes), copies=copies, max_iter=max_iter,
                                                        dtype=dtype, mode_layouts=policy, device=dev,
                                                        return_run=True)
            runs[policy].append(res)
            last[policy] = (results, rep)
            print(f"turn {turn} {policy}: wall {res['wall_s']} s, {res['models_per_sec']} models/s, "
                  f"{res['mttkrp_tflops']} TFLOP/s, warm-up {res['warmup_s']} s, lookups {res['lut_dispatch']}"
                  + (f", peak {res['hbm_measured']['peak_bytes_in_use'] / 2**30:.3f} GiB" if "hbm_measured" in res
                     else ""), flush=True)
    for policy, rs in runs.items():
        best = min(rs, key=lambda r: r["wall_s"])
        out[policy] = dict(best, hbm_reckoned=reckoned[policy], walls_s=[r["wall_s"] for r in rs],
                           warmups_s=[r["warmup_s"] for r in rs])
    out["checks"] = check(last, runs, require_exact=dev.type == "cuda")
    return out, last


def check(last: dict, runs: dict, require_exact: bool) -> dict:
    """Equal iteration counts and fits within ``FIT_BAND`` between the two
    policies' last runs; every lookup exact with ``require_exact``. Raises
    on a failure; returns the readings."""
    (res_a, rep_a), (res_b, rep_b) = last[POLICIES[0]], last[POLICIES[1]]
    a = {m.id: m for m in rep_a.models}
    b = {m.id: m for m in rep_b.models}
    if a.keys() != b.keys():
        raise AssertionError("layout A/B: the two policies fitted different models")
    iters = sum(a[i].iters != b[i].iters for i in a)
    fit = max(abs(a[i].fit - b[i].fit) for i in a)
    factors = max(float((torch.as_tensor(fa, dtype=torch.float64) - torch.as_tensor(fb, dtype=torch.float64))
                        .abs().max()) for ka, kb in zip(res_a, res_b) for fa, fb in zip(ka.factors, kb.factors))
    if iters:
        raise AssertionError(f"layout A/B: {iters} models with another iteration count under {POLICIES[1]}")
    if not fit <= FIT_BAND:
        raise AssertionError(f"layout A/B: fits {fit:g} apart (band {FIT_BAND:g})")
    if require_exact:
        for policy, rs in runs.items():
            for r in rs:
                if r["lut_dispatch"]["nearest"] or r["lut_dispatch"]["heuristic"]:
                    raise AssertionError(f"layout A/B {policy}: lookup decisions {r['lut_dispatch']}, all exact "
                                         f"expected")
    out = {"iteration_mismatches": iters, "max_abs_fit_diff": fit, "max_abs_factor_diff": factors}
    print(f"layout A/B checks: {out}", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--modes", default="500-500-500")
    p.add_argument("--copies", type=int, default=250)
    p.add_argument("--max-iter", type=int, default=50)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default=os.path.join("chiprun_out", "experiments"))
    args = p.parse_args(argv)
    modes = tuple(int(m) for m in args.modes.split("-"))
    out, _ = ab(modes, args.copies, args.max_iter, args.turns, device=args.device)
    print(out["card"], flush=True)
    for policy in POLICIES:
        e = out[policy]
        print(f"{policy}: {e['models_per_sec']} models/s, {e['mttkrp_tflops']} TFLOP/s (best of walls "
              f"{e['walls_s']} s), reckoned {(e['hbm_reckoned']['tensor'] + e['hbm_reckoned']['held_layouts']) / 1e9:.3f}"
              f" GB" + (f", measured peak {e['hbm_measured']['peak_bytes_in_use'] / 1e9:.3f} GB"
                        if "hbm_measured" in e else ""), flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "scale_sweep_layout_policy.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
