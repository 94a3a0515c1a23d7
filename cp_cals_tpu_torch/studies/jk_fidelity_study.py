"""Jackknife float32 on the card against float64: the standard-error bands
(port of the JAX repo's ``scripts/jk_fidelity_study.py``).

The reference runs its jackknife in float64 end to end
(experiments_jk.cpp:34-98); the port's fast tiers run float32 on the card.
This study measures what users consume, the per-parameter jackknife
standard-error bands, at each float32 tier against float64 on the same
base model:

  1. ``--prepare``: fit the rank-5 base model of the EEM-shaped synthetic
     tensor with the port's ``cp_als`` in float64 (from
     ``prng.random_ktensor`` of key 3, whose draws are JAX's bit for bit)
     and save it as ``jk_fidelity_base.npz`` in ``--out``.
  2. ``--oracle``: ``jk_cp_cals`` in float64 on the base -> SE bands
     (``jk_fidelity_f64.npz``).
  3. default: the same in float32 at ``--tier`` -> ``jk_fidelity_<tag>.npz``.
  4. ``--compare``: every tier's bands against the float64 bands, the
     dtype-induced SE error against the jackknife scatter itself
     (``jk_fp32_vs_fp64.json``).

The runs read the base from ``--base``, by default the JAX package's
committed ``data/benchmarks/jk_fidelity_base.npz``, so that their float64
bands are comparable with the committed ``jk_fidelity_f64.npz``; compare
reads the float64 bands from ``--out`` where an ``--oracle`` run wrote
them, else the committed ones (its ``oracle`` key says which). Every stage
runs on the card unless ``--device cpu`` is given.

Jackknife SE per parameter (column-matched by jk_cp_cals's LSAP
adjustment, so entrywise comparable): se = sqrt((n-1)/n * sum_i
(theta_i - theta_bar)^2), excluded-fiber rows (NaN) dropped per replicate.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import AlsParams, CalsParams
from ..device import resolve_device
from ..experiments import device_line
from ..ktensor import Ktensor, random_ktensor
from ..prng import prng_key
from ..solvers import cp_als, jk_cp_cals
from ._common import OUT_DIR, committed_oracle_path, load_npz, oracle_source, write_json

MODES = (299, 301, 41)
RANK = 5
# The float32 tiers under study, by output tag, in compare's order.
TIERS = {
    "f32": "default",
    "f32_high": "high",
    "f32_high_xla": "high_xla",
    "f32_high_dimtree": "high_dimtree",
    "f32_default_check": "default_check",
    "f32_default_polish_conv": "default_polish_conv",
}


def build_inputs(modes=None, rank=None):
    """The synthetic tensor, float64, from ``default_rng(7)``: a rank-5
    model plus 5 % noise (``modes`` and ``rank`` default to MODES and
    RANK)."""
    modes, rank = modes or MODES, rank or RANK
    rng = np.random.default_rng(7)
    factors = [rng.standard_normal((m, rank)) for m in modes]
    lam = np.abs(rng.standard_normal(rank)) + 0.5
    x = np.einsum("ir,jr,kr,r->ijk", *factors, lam)
    return x + 0.05 * x.std() * rng.standard_normal(x.shape)


def se_bands(replicates):
    """Per-parameter jackknife standard errors, NaN fiber rows excluded."""
    out = []
    n_modes = len(replicates[0].factors)
    for mode in range(n_modes):
        stack = np.stack([np.asarray(k.factors[mode], np.float64) for k in replicates])  # [n_rep, I, R]
        n = np.sum(np.isfinite(stack), axis=0)  # per-entry replicate count
        mean = np.nanmean(stack, axis=0)
        var = np.nansum((stack - mean) ** 2, axis=0)
        out.append(np.sqrt(np.maximum(n - 1, 1) / np.maximum(n, 1) * var))
    return out


def tier_params(tier: str = "default", is_f64: bool = False, polish=None, **over) -> CalsParams:
    """The script's engine settings of a tier ("default": the bench's bf16
    MTTKRP and 2 polish sweeps; "high": the bf16 hi/lo tier everywhere;
    "high_xla": "high" on the unfused epilogue, the control of the
    jackknife's fused-epilogue pin; "high_dimtree": "high" with the
    dimension tree; "default_check": bf16 with the mixed-tier check every 5
    iterations and 2 polish sweeps; "default_polish_conv": the check and a
    polish to convergence at "high", at most 25 sweeps) or of the float64
    oracle (``is_f64``: "highest", no polish). ``polish`` overrides
    ``polish_iters``; ``over`` sets further fields (the phases that count
    kernel launches pin the MTTKRP method)."""
    high = tier in ("high", "high_dimtree", "high_xla")
    return CalsParams(
        tol=1e-6,
        max_iterations=100,
        buffer_size=2432,
        bucket_ranks=(8,),
        precision="highest" if is_f64 else "high",
        mttkrp_precision=None if (is_f64 or high) else "default",
        tol_check_interval=5 if tier in ("default_check", "default_polish_conv") else 0,
        polish_iters=(
            (25 if tier == "default_polish_conv" else 0 if (is_f64 or high) else 2)
            if polish is None else polish
        ),
        polish_tol=1e-6 if tier == "default_polish_conv" else 0.0,
        dimtree="on" if tier == "high_dimtree" else "off",
        epilogue="xla" if tier == "high_xla" else "auto",
        sync_mode="evict",
        **over,
    )


def load_base(path: str, dtype=torch.float64) -> Ktensor:
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("f"))
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return Ktensor(tuple(data[f"f{m}"].astype(np_dtype) for m in range(n)), data["lam"].astype(np_dtype))


def run(dtype, tag: str, tier: str = "default", polish=None, base: str | None = None, device=None,
        out_dir: str = OUT_DIR, **over) -> dict:
    """``jk_cp_cals`` of the base model (``base``: a ``.npz`` path, default
    the committed one) on the synthetic tensor at ``dtype`` and ``tier``;
    its SE bands go to ``jk_fidelity_<tag>.npz`` in ``out_dir``. Returns the
    run's summary, with the bands under "bands" and the report under
    "report"."""
    dev = resolve_device(device)
    base = base or committed_oracle_path("jk_fidelity_base.npz")
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    # The tensor is deterministic from build_inputs(); only the fitted base
    # model is shared through disk.
    x = torch.from_numpy(build_inputs().astype(np_dtype)).to(dev)
    params = tier_params(tier, dtype == torch.float64, polish, **over)
    t0 = time.perf_counter()
    rep = jk_cp_cals(x, [load_base(base, dtype)], params, device=dev)
    wall = time.perf_counter() - t0
    reps = rep.results[0]
    bands = se_bands(reps)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, f"jk_fidelity_{tag}.npz"), **{f"se{m}": b for m, b in enumerate(bands)})
    out = {
        "tag": tag,
        "device": device_line(dev),
        "dtype": str(dtype).removeprefix("torch."),
        "base": base,
        "n_replicates": len(reps),
        "wall_s": wall,
        "mean_se": [float(np.mean(b)) for b in bands],
    }
    print(json.dumps(out))
    return {**out, "bands": bands, "report": rep}


def compare_bands(se64: dict, tiers: dict) -> dict:
    """The script's comparison: for each tier's bands ({tag: {"se<m>":
    array}}) and each mode, the mean SEs, the mean and max |dtype error|,
    and that error over the jackknife scatter (mean, and the p99 of the
    entrywise ratio)."""
    out = {}
    for tag, b in tiers.items():
        rows = []
        for m in range(len([k for k in se64 if k.startswith("se")])):
            s64, s32 = se64[f"se{m}"], b[f"se{m}"]
            d = np.abs(s32 - s64)
            rows.append({
                "mode": m,
                "mean_se_f64": float(s64.mean()),
                "mean_se_f32": float(s32.mean()),
                "mean_abs_dtype_err": float(d.mean()),
                "max_abs_dtype_err": float(d.max()),
                # Is the dtype-induced SE error small against the jackknife
                # scatter users read?
                "dtype_err_over_scatter_mean": float(d.mean() / max(s64.mean(), 1e-300)),
                "dtype_err_over_scatter_p99": float(np.quantile(d / np.maximum(s64, 1e-12), 0.99)),
            })
        out[tag] = rows
    return out


def compare(out_dir: str = OUT_DIR) -> dict:
    """Join the tiers' bands in ``out_dir`` with the float64 bands into
    ``jk_fp32_vs_fp64.json``."""
    src = oracle_source("jk_fidelity_f64.npz", out_dir)
    tiers = {tag: load_npz(os.path.join(out_dir, f"jk_fidelity_{tag}.npz")) for tag in TIERS
             if os.path.exists(os.path.join(out_dir, f"jk_fidelity_{tag}.npz"))}
    out = {"modes": list(MODES), "rank": RANK, "oracle": src, "tiers": compare_bands(load_npz(src), tiers)}
    path = write_json(out_dir, "jk_fp32_vs_fp64.json", out)
    print(json.dumps(out))
    print(f"wrote {path}")
    return out


def prepare(device=None, out_dir: str = OUT_DIR) -> str:
    """Fit the base model in float64 and save it to ``out_dir``."""
    dev = resolve_device(device)
    x = torch.from_numpy(build_inputs()).to(dev)
    kt0 = random_ktensor(prng_key(3, dev), MODES, RANK, dtype=torch.float64)
    kt, _ = cp_als(x, kt0, AlsParams(tol=1e-9, max_iterations=500, precision="highest"), device=dev)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "jk_fidelity_base.npz")
    np.savez_compressed(path, lam=np.asarray(kt.lam, np.float64),
                        **{f"f{m}": np.asarray(f, np.float64) for m, f in enumerate(kt.factors)})
    print(f"prepared base model -> {path}")
    return path


def tag_of(oracle: bool, tier: str) -> str:
    return "f64" if oracle else ("f32" if tier == "default" else f"f32_{tier}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--prepare", action="store_true")
    p.add_argument("--oracle", action="store_true")
    p.add_argument("--compare", action="store_true")
    p.add_argument("--polish-iters", type=int, default=None,
                   help="override polish_iters for the float32 tier under study")
    p.add_argument("--tier", default="default", choices=tuple(TIERS.values()),
                   help="float32 tier: default (bf16 MTTKRP), high (bf16 hi/lo), ...")
    p.add_argument("--base", default=None,
                   help="the base model (.npz; default: the committed data/benchmarks/jk_fidelity_base.npz)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    if args.compare:
        return compare(args.out)
    if args.prepare:
        return prepare(args.device, args.out)
    return run(
        torch.float64 if args.oracle else torch.float32,
        tag_of(args.oracle, args.tier),
        tier=args.tier,
        # The override applies to the float32 tier under study only: the
        # float64 oracle keeps polish at 0 to stay the baseline.
        polish=None if args.oracle else args.polish_iters,
        base=args.base,
        device=args.device,
        out_dir=args.out,
    )


if __name__ == "__main__":
    main()
