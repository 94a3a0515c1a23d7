#!/usr/bin/env python3
"""Time the engine's MTTKRP dispatch from the lookup table against the
fixed rule (mttkrp_method=PALLAS: the fused kernels wherever their gate
takes the mode, the twostep elsewhere) on the card, in turns.

    python3 tools/lut_walls.py [--turns N]

1. The bench workload (299x301x41, 400 models, buckets 4/8/12/16/20,
   buffer_size=2880, 10 forced iterations) at the bench tiers: walls under
   AUTO (the committed table) and pinned, in turns A P P A A P ...
2. The README's CLI command (``-t 299-301-41 -c 1:20:20 --compare-als
   --jk``) through ``cli.main``, its CALS and jackknife runs under AUTO
   and pinned (batched ALS reads no table either way), in the same turns:
   the whole wall and its CALS, batched-ALS and jackknife lines.
3. The 4-D bench workload (299x301x41x8) at the bench tiers, under AUTO and
   pinned (every mode on the twostep): wall, device busy time under
   torch.profiler, the reported mean fit and the mean fit of the dense
   reconstructions.
4. One MTTKRP of 299x301x41 at R = 20 per mode: the native C++/OpenMP
   MTTKRP in float64 on the host (``native/mttkrp_native.py``, the least of
   5) beside the card's three routes in float32 at "highest" (one model,
   and the rank-20 bucket's B = 32), replayed from a CUDA graph.

Prints the card's name and power limit, and writes chiprun_out/lut_walls.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench workload, the README command, timing helpers)
from cp_cals_tpu_torch import MttkrpMethod, cli, cp_cals, solvers  # noqa: E402
from cp_cals_tpu_torch.ktensor import to_tensor  # noqa: E402
from cp_cals_tpu_torch.native.mttkrp_native import mttkrp3  # noqa: E402
from cp_cals_tpu_torch.ops import mttkrp as mt  # noqa: E402
from cp_cals_tpu_torch.utils import lut  # noqa: E402

KINDS = {"table": MttkrpMethod.AUTO, "fixed": MttkrpMethod.PALLAS}


def turns(n: int) -> list:
    """table, fixed, fixed, table, table, fixed, ...: n of each."""
    out = []
    while len(out) < 2 * n:
        out += ["table", "fixed"] if len(out) % 4 == 0 else ["fixed", "table"]
    return out[:2 * n]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


@contextlib.contextmanager
def cli_method(method):
    """The CLI's CALS and jackknife runs with ``mttkrp_method=method``."""
    real_cals, real_jk = solvers.cp_cals, solvers.jk_cp_cals
    solvers.cp_cals = lambda x, q, p, **kw: real_cals(x, q, dataclasses.replace(p, mttkrp_method=method), **kw)
    solvers.jk_cp_cals = lambda x, f, p, **kw: real_jk(x, f, dataclasses.replace(p, mttkrp_method=method), **kw)
    try:
        yield
    finally:
        solvers.cp_cals, solvers.jk_cp_cals = real_cals, real_jk


def dense_fits(x, results) -> float:
    xt = torch.from_numpy(x).cuda()
    xn = torch.linalg.vector_norm(xt)
    fits = []
    for kt in results:
        k = type(kt)(tuple(torch.from_numpy(f).cuda() for f in kt.factors), torch.from_numpy(kt.lam).cuda())
        fits.append(float(1 - torch.linalg.vector_norm(xt - to_tensor(k)) / xn))
    return float(np.mean(fits))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--turns", type=int, default=3)
    args = p.parse_args(argv)
    card = chip_smoke.card_line()
    print(card, flush=True)
    out = dict(card=card)
    order = turns(args.turns)

    # 1. The bench workload at the bench tiers.
    x_np, rng = chip_smoke.bench_tensor()
    queue = chip_smoke.engine_queue(rng)
    for kind in ("table", "fixed"):  # warm-up: kernels built, graphs' first captures
        cp_cals(x_np, queue[::80], chip_smoke.bench_params(mttkrp_method=KINDS[kind], **chip_smoke.BENCH_TIERS))
    walls = {"table": [], "fixed": []}
    lut.reset_lookup_stats()
    for kind in order:
        params = chip_smoke.bench_params(mttkrp_method=KINDS[kind], **chip_smoke.BENCH_TIERS)
        wall, (_, rep) = timed(lambda: cp_cals(x_np, queue, params))
        walls[kind].append(wall)
    out["bench_tiers"] = dict(order=order, walls_s=walls, lut_dispatch=dict(lut.LOOKUP_STATS),
                              picks={str(r): list(m) for r, (m, _) in chip_smoke.bucket_picks(
                                  x_np.shape, [kt.rank for kt in queue],
                                  chip_smoke.bench_params(**chip_smoke.BENCH_TIERS)).items()})
    print(f"bench tiers, 10 forced iterations, walls in turns {order}: table {walls['table']}, fixed rule "
          f"{walls['fixed']} s; picks {out['bench_tiers']['picks']}", flush=True)

    # 2. The README command.
    lines = {k: re.compile(v) for k, v in chip_smoke.CLI_LINES.items() if k in ("cals", "als", "jk")}
    runs = {"table": [], "fixed": []}
    for kind in order:
        buf = io.StringIO()
        with cli_method(KINDS[kind]), contextlib.redirect_stdout(buf):
            wall, _ = timed(lambda: cli.main(chip_smoke.README_CLI))
        got = {}
        for ln in buf.getvalue().splitlines():
            for k, rx in lines.items():
                m = rx.match(ln)
                if m:
                    got[k] = m.groups()
        runs[kind].append(dict(wall_s=wall, cals_s=float(got["cals"][0]), cals_models_per_s=float(got["cals"][1]),
                               mean_fit=float(got["cals"][2]), mean_iters=float(got["cals"][3]),
                               als_s=float(got["als"][0]), jk_s=float(got["jk"][1])))
        print(f"README command ({kind}): {runs[kind][-1]}", flush=True)
    out["readme_cli"] = dict(order=order, runs=runs)

    # 3. The 4-D bench workload at the bench tiers.
    x4, rng4 = chip_smoke.bench_tensor(chip_smoke.MODES4)
    queue4 = chip_smoke.engine_queue(rng4, chip_smoke.MODES4)
    nd = {}
    for kind in ("table", "fixed", "fixed", "table"):
        params = chip_smoke.bench_params(mttkrp_method=KINDS[kind], **chip_smoke.BENCH_TIERS)
        wall, (res, rep) = timed(lambda: cp_cals(x4, queue4, params))
        if kind not in nd:
            prof = chip_smoke.profiled(lambda: cp_cals(x4, queue4, params))
            nd[kind] = dict(walls_s=[], busy_ms=prof["busy_ms"], busy_share=prof["busy_share"],
                            kernel_ms=prof["kernel_ms"], mean_fit=float(np.mean([m.fit for m in rep.models])),
                            mean_dense_fit=dense_fits(x4, res))
        nd[kind]["walls_s"].append(wall)
    out["nd_bench_tiers"] = nd
    for kind, v in nd.items():
        print(f"4-D bench tiers ({kind}): walls {v['walls_s']} s, device busy {v['busy_ms']:.2f} ms "
              f"({v['busy_share']:.3f} of a profiled wall), mean fit {v['mean_fit']:.6f}, mean dense fit "
              f"{v['mean_dense_fit']:.6f}", flush=True)

    # 4. One MTTKRP at R = 20: the native OpenMP MTTKRP beside the card's routes.
    gen = np.random.default_rng(0)
    x64 = x_np.astype(np.float64)
    fs64 = [gen.standard_normal((m, 20)) for m in x_np.shape]
    native = {}
    for mode in range(3):
        mttkrp3(x64, fs64, mode)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            mttkrp3(x64, fs64, mode)
            ts.append(time.perf_counter() - t0)
        native[mode] = min(ts) * 1e3
    x = torch.from_numpy(x_np).cuda()
    card_ms = {}
    for b in (1, 32):
        factors = [torch.from_numpy(np.repeat(f[None], b, 0).astype(np.float32)).cuda() for f in fs64]
        for mode in range(3):
            for method in lut.METHODS:
                held = mt.prepare_mode(x, mode, method, "highest")
                card_ms[f"B{b}:{mode}:{method}"] = chip_smoke.graph_ms(
                    lambda: mt.mttkrp_batched(x, factors, mode, method, "highest", held))
    out["mttkrp_r20"] = dict(native_f64_host_ms=native, card_fp32_highest_graph_ms=card_ms,
                             host_threads=os.cpu_count())
    print(f"MTTKRP 299x301x41 R=20: native float64 on the host ({os.cpu_count()} cores) ms by mode {native}; "
          f"the card, float32 'highest', replayed ms {card_ms}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "lut_walls.json"), "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
