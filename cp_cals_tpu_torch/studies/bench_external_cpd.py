"""Cross-check and cross-time CP-ALS against external implementations
(port of the JAX repo's ``scripts/bench_external_cpd.py``).

The reference validates itself against an external ecosystem (MATLAB
TensorToolbox, ``matlab/matlab_src/TTB_vs_CALS.m``): the same workload
fitted by an implementation it does not own, fits cross-checked, walls
compared. The contenders here:

  * torch CP-ALS (``cp_als_torch``, float64 on the CPU): einsum MTTKRPs and
    Cholesky solves on PyTorch's primitives; shares no code or contraction
    strategy with the engine.
  * NumPy textbook CP-ALS (``external_cp_als.cp_als_numpy``, float64):
    pinv-based normal equations, explicit Khatri-Rao.
  * this port's ``cp_cals`` on the CPU in float64 (the kernels' plain
    versions): the same-hardware point beside the two.

All three run the same workload from the same inits for the same forced
iterations, so their fits agree to float64 trajectory tolerance: that
agreement is the cross-validation, and the walls the comparison. A second
invocation with ``--card`` (the script's ``--tpu``) adds the production
engine's row on the card (float32 at the bench's fast tier: a "default"
MTTKRP under "high", one polish sweep), its fits held against the float64
torch contender's: those of ``--out``'s file where the CPU phase wrote
one, else the JAX package's committed ``data/benchmarks/external_cpd.json``
(float64 rows only; the row's ``reference`` key says which).

    python -m cp_cals_tpu_torch.studies.bench_external_cpd          # CPU contenders + cross-check
    python -m cp_cals_tpu_torch.studies.bench_external_cpd --card   # add the card's row

Writes ``external_cpd.json`` into ``--out`` (default ``chiprun_out/experiments``).
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
from ..ktensor import Ktensor
from ._common import OUT_DIR, bench_tensor, best_of, committed_oracle, committed_oracle_path, load_json, write_json
from .external_cp_als import cp_als_numpy, reconstruct

MODES = (299, 301, 41)
RANKS = range(1, 21)
N_ITER = 20  # forced, so every contender does identical work


def build_workload():
    """The bench workload's tensor and plain-NumPy matched inits, float64,
    at MODES and RANKS: every contender takes the same arrays (the card's
    row casts them to float32)."""
    modes, ranks = MODES, RANKS
    rng = np.random.default_rng(42)
    x = bench_tensor(rng, modes)
    inits = []
    for r in ranks:
        factors = [rng.uniform(-1.0, 1.0, (m, r)) for m in modes]
        inits.append((factors, np.ones(r)))
    return x, inits


def fit_of(x, factors, lam, x_norm):
    err = np.linalg.norm(x - reconstruct(list(factors), lam))
    return 1.0 - err / x_norm


def cp_als_torch(x_t, factors0, lam0, n_iter):
    """CP-ALS on torch primitives: einsum MTTKRPs, cholesky_solve normal
    equations, the reference's normalization schedule. Independent of the
    engine and of the NumPy contender (pinv path)."""
    factors = [torch.as_tensor(f, dtype=torch.float64) for f in factors0]
    n_modes = x_t.ndim
    subs = "abc"
    for it in range(1, n_iter + 1):
        for n in range(n_modes):
            others = [m for m in range(n_modes) if m != n]
            # MTTKRP via one einsum, e.g. n=1: "abc,ar,cr->br".
            operands, script = [x_t], subs
            for m in others:
                operands.append(factors[m])
                script += f",{subs[m]}r"
            g = torch.einsum(script + f"->{subs[n]}r", *operands)
            h = torch.ones_like(factors[0][:1, :].T @ factors[0][:1, :])
            for m in others:
                h = h * (factors[m].T @ factors[m])
            u = torch.cholesky_solve(g.T, torch.linalg.cholesky(h)).T
            if it == 1:
                norms = torch.linalg.norm(u, dim=0)
            else:
                mx, mn = u.max(dim=0).values, u.min(dim=0).values
                norms = torch.where(mx >= -mn, mx, mn)
            safe = torch.where(norms == 0, torch.ones_like(norms), norms)
            factors[n] = u / safe
            lam = norms
    return [f.numpy() for f in factors], lam.numpy()


def queue_at(inits, np_dtype) -> list:
    return [Ktensor(tuple(np.asarray(f, np_dtype) for f in f0), np.asarray(l0, np_dtype)) for f0, l0 in inits]


def port_params(**over) -> CalsParams:
    """The float64 CPU row's settings (the script's :243)."""
    return CalsParams(tol=0.0, max_iterations=N_ITER, force_max_iter=True, bucket_ranks=(4, 8, 12, 16, 20),
                      buffer_size=2880, **over)


def card_params(**over) -> CalsParams:
    """The card row's settings: the production fast tier (the script's
    :158-163). ``over`` sets further fields (the phases that count kernel
    launches pin the MTTKRP method)."""
    return port_params(precision="high", mttkrp_precision="default", polish_iters=1, result_wire_dtype="float16",
                       **over)


def fits_of(x, results) -> list:
    x_norm = float(np.linalg.norm(x))
    return [fit_of(x, [np.asarray(f, np.float64) for f in kt.factors], np.asarray(kt.lam, np.float64), x_norm)
            for kt in results]


def card_row(x, inits, ref_fits, device=None, reps: int = 3, warm: bool = True, **over) -> dict:
    """The engine's float32 row on ``device`` (None: the card), its fits
    against ``ref_fits``; under "report", the last run's engine report."""
    dev = resolve_device(device)
    xq = torch.from_numpy(x.astype(np.float32)).to(dev)
    results, rep, wall = best_of(xq, queue_at(inits, np.float32), card_params(**over), dev, reps, warm)
    fits = fits_of(x, results)
    return {
        "device": device_line(dev),
        "wall_s": wall,
        "models_per_sec": len(inits) / wall,
        "fits": [round(float(f), 8) for f in fits],
        "max_abs_fit_diff_vs_torch": float(np.max(np.abs(np.array(fits) - np.array(ref_fits)))),
        "note": "production fast tier (bf16 MTTKRP + 1 polish sweep), forced to the same 20 iterations",
        "report": rep,
    }


def cpu_phase(x, inits) -> dict:
    """The three float64 CPU contenders and their cross-check."""
    x_norm = float(np.linalg.norm(x))
    n_models = len(inits)
    out = {
        "workload": {"modes": list(x.shape), "ranks": [inits[0][1].size, inits[-1][1].size], "n_models": n_models,
                     "forced_iterations": N_ITER, "matched_inits": True},
        "contenders": {},
    }
    x_t = torch.as_tensor(x)
    t0 = time.perf_counter()
    torch_fits = [fit_of(x, *cp_als_torch(x_t, f0, l0, N_ITER), x_norm) for f0, l0 in inits]
    wall = time.perf_counter() - t0
    out["contenders"]["torch_cpu_fp64"] = {"wall_s": wall, "models_per_sec": n_models / wall,
                                           "threads": torch.get_num_threads(),
                                           "fits": [round(float(f), 8) for f in torch_fits]}
    t0 = time.perf_counter()
    np_fits = [fit_of(x, *cp_als_numpy(x, f0, l0, N_ITER), x_norm) for f0, l0 in inits]
    wall = time.perf_counter() - t0
    out["contenders"]["numpy_cpu_fp64"] = {"wall_s": wall, "models_per_sec": n_models / wall,
                                           "fits": [round(float(f), 8) for f in np_fits]}
    cpu = torch.device("cpu")
    results, _, wall = best_of(torch.as_tensor(x), queue_at(inits, np.float64), port_params(), cpu, reps=1)
    port_fits = fits_of(x, results)
    out["contenders"]["cp_cals_tpu_torch_on_cpu_fp64"] = {"wall_s": wall, "models_per_sec": n_models / wall,
                                                          "fits": [round(float(f), 8) for f in port_fits]}
    # Identical inits and forced iterations: the float64 trajectories of
    # independent implementations agree.
    tf, nf, pf = map(np.array, (torch_fits, np_fits, port_fits))
    out["cross_check"] = {
        "max_abs_fit_diff_torch_vs_numpy": float(np.max(np.abs(tf - nf))),
        "max_abs_fit_diff_torch_vs_ours": float(np.max(np.abs(tf - pf))),
        "max_abs_fit_diff_numpy_vs_ours": float(np.max(np.abs(nf - pf))),
    }
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--card", "--tpu", dest="card", action="store_true",
                   help="add the production engine's row on --device to the CPU phase's file")
    p.add_argument("--device", default="cuda", help="the --card row's device: cuda (the default) or cpu")
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    x, inits = build_workload()
    path = os.path.join(args.out, "external_cpd.json")
    if args.card:
        own = load_json(path) if os.path.exists(path) else {}
        if "torch_cpu_fp64" in own.get("contenders", {}):
            out, ref = own, path
            ref_fits = own["contenders"]["torch_cpu_fp64"]["fits"]
        else:
            ref = committed_oracle_path("external_cpd.json")
            committed = committed_oracle("external_cpd.json")
            out = {"workload": committed["workload"], "contenders": {}}
            ref_fits = committed["contenders"]["torch_cpu_fp64"]["fits"]
        row = card_row(x, inits, ref_fits, args.device)
        row.pop("report")
        row["reference"] = ref
        out["contenders"]["cp_cals_tpu_torch_f32"] = row
        write_json(args.out, "external_cpd.json", out)
        print(json.dumps(row))
        return out

    torch.set_num_threads(os.cpu_count() or 4)
    out = cpu_phase(x, inits)
    write_json(args.out, "external_cpd.json", out)
    print(json.dumps(out["cross_check"]))
    for name, row in out["contenders"].items():
        print(name, row["wall_s"], "s,", row["models_per_sec"], "models/s")
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
