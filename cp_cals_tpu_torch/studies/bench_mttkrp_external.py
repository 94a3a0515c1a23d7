"""External MTTKRP comparison (port of the JAX repo's
``scripts/bench_mttkrp_external.py``).

The reference pits its MTTKRP against independent implementations on the
same shapes (its ``benchmark_other_mttkrp`` against CTF and PLANC). Here
the port's MTTKRP routes on ``--device`` (default: the CUDA card) stand
beside independent CPU implementations on the card's host:

* ``cpp_omp``: the C++/OpenMP MTTKRP written from the definition
  (``native/mttkrp_ref.cpp``, built with g++ at first use; a failed build
  raises), 3-D tensors;
* ``torch_krp`` / ``torch_twostep``: ``torch`` on the CPU, in the
  KRP-materialising and the two-step (TTM + TTV) formulations;
* ``np_krp`` / ``np_twostep``: NumPy (BLAS through ``tensordot``);
* ``ours_krp`` / ``ours_twostep``: ``ops/mttkrp.mttkrp`` (krp_gemm,
  twostep) in float64 at "highest" on ``--device``, the device-to-host copy
  of the result included, as the JAX contender includes ``np.asarray``.

Every float64 result is held to the NumPy KRP oracle at 1e-10 relative to
its largest magnitude, and a contender that disagrees fails the run. With
``--device cpu`` every contender runs on one CPU: the JAX script's
same-hardware comparison.

On the card each 3-D shape and rank adds float32 rows of the hand-written
fused MTTKRP kernels, one model (B = 1) through
``ops/mttkrp.mttkrp_batched(..., method="pallas")`` on the tier's held
layout of X (prepared once, outside the timing, as the engine holds it):
``ours_fused_highest`` (``fused_mttkrp_fp32``, strict fp32) and
``ours_fused_default`` (``fused_mttkrp_tc``, one bf16 pass). Each is held
to its plain version at the same tier at 2e-5 of the largest magnitude
(the kernel phase's tolerance) and its relative difference from the
float64 oracle is reported without a gate. A (shape, mode, rank) that the
fused gate (``ops/fused_mttkrp.py:fused_mttkrp_supported``) refuses gets
``null`` times and the gate's word ``"refused"``; nothing is rerouted.
Each such row counts the kernel's launches (``_launches``): the timing's
warm-up and timed reps; the check compares the last rep's result.

Times are the least of ``--reps`` wall times after one warm-up call
(the reference's min-of-reps), on the host's clock.

    python -m cp_cals_tpu_torch.studies.bench_mttkrp_external \\
        [--tensors 100-100-100,299-301-41] [--ranks 5,20,100] [--reps 3] \\
        [--device cuda|cpu] [--out chiprun_out/experiments]

Writes ``external_mttkrp.json`` into ``--out``: the JAX script's ``note``,
``cpus`` and ``rows`` (each row ``tensor``, ``rank``, ``mode``, ``flops``,
``<contender>_s`` and ``<contender>_gflops``), plus ``device``, ``card``
(the card's name and power limit as nvidia-smi gives them, "cpu" off the
card), and per row ``devices``, where each contender ran, and
``vs_oracle``, each float64 contender's relative difference from the
oracle.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import launches
from ..device import resolve_device
from ..experiments import device_line
from ..native.mttkrp_native import mttkrp3 as cpp_mttkrp3
from ..ops.fused_mttkrp import fused_mttkrp_plain, fused_mttkrp_supported, split_others
from ..ops.mttkrp import mttkrp, mttkrp_batched, mttkrp_flops, prepare_mode
from ._common import OUT_DIR, write_json

TOL = 1e-10  # every float64 contender against the NumPy oracle (the script's)
FUSED_TOL = 2e-5  # a fused row against its plain version, of max|G| (chip_smoke.TOL["mttkrp"])
# The float32 rows' tiers and the kernel each launches on the card.
FUSED_TIERS = {"highest": "fused_mttkrp_fp32", "default": "fused_mttkrp_tc"}
CONTENDERS = ("ours_krp", "ours_twostep", "torch_krp", "torch_twostep", "np_krp", "np_twostep", "cpp_omp")


def timeit(fn, reps):
    """Min-of-reps wall time (the reference's bench_utils.h min-of-3)."""
    best = float("inf")
    for _ in range(reps + 1):  # +1 warmup rep, not counted
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
    return best, out


# --- NumPy contenders (also the correctness oracle) -----------------------


def np_mttkrp_krp(x, factors, mode):
    others = [m for m in range(x.ndim) if m != mode]
    krp = factors[others[0]]
    for m in others[1:]:
        krp = (krp[:, None, :] * factors[m][None, :, :]).reshape(-1, krp.shape[-1])
    xu = np.transpose(x, (mode, *others)).reshape(x.shape[mode], -1)
    return xu @ krp


def np_mttkrp_twostep(x, factors, mode):
    others = [m for m in range(x.ndim) if m != mode]
    order = sorted(others, key=lambda m: -x.shape[m])
    t = np.tensordot(x, factors[order[0]], axes=([order[0]], [0]))
    live = [m for m in range(x.ndim) if m != order[0]]
    for m in order[1:]:
        ax = live.index(m)
        t = np.einsum(
            t, list(range(t.ndim)),
            factors[m], [ax, t.ndim - 1],
            [i for i in range(t.ndim) if i != ax],
        )
        live.pop(ax)
    return t


# --- torch contenders ------------------------------------------------------


def torch_mttkrp_krp(x, factors, mode):
    others = [m for m in range(x.ndim) if m != mode]
    krp = factors[others[0]]
    for m in others[1:]:
        krp = (krp[:, None, :] * factors[m][None, :, :]).reshape(-1, krp.shape[-1])
    xu = x.permute(mode, *others).reshape(x.shape[mode], -1)
    return xu @ krp


def torch_mttkrp_twostep(x, factors, mode):
    others = [m for m in range(x.ndim) if m != mode]
    order = sorted(others, key=lambda m: -x.shape[m])
    t = torch.tensordot(x, factors[order[0]], dims=([order[0]], [0]))
    live = [m for m in range(x.ndim) if m != order[0]]
    for m in order[1:]:
        ax = live.index(m)
        letters = "abcdefghij"
        in1 = letters[: t.ndim]
        in2 = letters[ax] + letters[t.ndim - 1]
        out = "".join(c for i, c in enumerate(in1) if i != ax)
        t = torch.einsum(f"{in1},{in2}->{out}", t, factors[m])
        live.pop(ax)
    return t


# --- the rows --------------------------------------------------------------


def rel_diff(out, ref) -> float:
    """max|out - ref| over max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / max(np.max(np.abs(ref)), 1e-30))


def contenders(x_np, f_np, x_d, f_d, mode: int) -> dict:
    """name -> (device type, a function of no arguments returning the
    result on the host) of the float64 contenders of one mode."""
    dev = x_d.device.type
    x_t, f_t = torch.from_numpy(x_np), [torch.from_numpy(f) for f in f_np]
    out = {
        "ours_krp": (dev, lambda: mttkrp(x_d, f_d, mode, "krp_gemm", "highest").cpu().numpy()),
        "ours_twostep": (dev, lambda: mttkrp(x_d, f_d, mode, "twostep", "highest").cpu().numpy()),
        "torch_krp": ("cpu", lambda: torch_mttkrp_krp(x_t, f_t, mode).numpy()),
        "torch_twostep": ("cpu", lambda: torch_mttkrp_twostep(x_t, f_t, mode).numpy()),
        "np_krp": ("cpu", lambda: np_mttkrp_krp(x_np, f_np, mode)),
        "np_twostep": ("cpu", lambda: np_mttkrp_twostep(x_np, f_np, mode)),
    }
    if x_np.ndim == 3:
        out["cpp_omp"] = ("cpu", lambda: cpp_mttkrp3(x_np, f_np, mode))
    return out


def fused_row(x32: torch.Tensor, f32: list, mode: int, tier: str, reps: int, oracle: np.ndarray,
              flops: int) -> dict:
    """The float32 row of the fused kernel of ``tier`` on one mode, one
    model: its ``ours_fused_<tier>_*`` keys. Where the gate refuses the mode
    at B = 1 the times are None and ``_gate`` says "refused"; otherwise the
    result is held to the plain version (raises beyond ``FUSED_TOL``)."""
    key = f"ours_fused_{tier}"
    r = f32[0].shape[-1]
    if not fused_mttkrp_supported(tuple(x32.shape), mode, 1, r, x32.dtype, x32.device):
        return {f"{key}_s": None, f"{key}_gflops": None, f"{key}_gate": "refused"}
    held = prepare_mode(x32, mode, "pallas", tier)
    fac = [f[None] for f in f32]
    kernel = FUSED_TIERS[tier]
    before = launches.read()[kernel]
    dt, out = timeit(lambda: mttkrp_batched(x32, fac, mode, "pallas", tier, held).cpu(), reps)
    n = launches.read()[kernel] - before
    small, big = split_others(tuple(x32.shape), mode)
    plain = fused_mttkrp_plain(held, fac[small], fac[big], tier).cpu()
    err = float((out - plain).abs().max() / plain.abs().max().clamp_min(1e-30))
    if not err <= FUSED_TOL:
        raise AssertionError(f"{kernel} at {tuple(x32.shape)} rank {r} mode {mode} ({tier}): {err:g} of max|G| "
                             f"from its plain version (limit {FUSED_TOL:g})")
    return {f"{key}_s": dt, f"{key}_gflops": flops / dt / 1e9, f"{key}_gate": "taken",
            f"{key}_launches": n, f"{key}_vs_plain": err, f"{key}_vs_f64": rel_diff(out[0].numpy(), oracle)}


def run(tensors: str = "100-100-100,299-301-41", ranks: str = "5,20,100", reps: int = 3, device=None) -> list[dict]:
    """The rows of the comparison (module docstring); on the card they
    include the float32 rows of the fused kernels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    print(f"{'tensor':>14} {'rank':>5} {'mode':>4} " + " ".join(f"{c:>13}" for c in CONTENDERS)
          + "  (GFLOP/s)", flush=True)
    for tstr in tensors.split(","):
        modes = tuple(int(m) for m in tstr.split("-"))
        x_np = rng.standard_normal(modes).astype(np.float64)
        x_d = torch.from_numpy(x_np).to(dev)
        x32 = x_d.to(torch.float32) if dev.type == "cuda" and len(modes) == 3 else None
        for r in (int(s) for s in ranks.split(",")):
            f_np = [rng.standard_normal((m, r)).astype(np.float64) for m in modes]
            f_d = [torch.from_numpy(f).to(dev) for f in f_np]
            f32 = [f.to(torch.float32) for f in f_d] if x32 is not None else None
            for mode in range(len(modes)):
                flops = mttkrp_flops(modes, r, mode)
                oracle = np_mttkrp_krp(x_np, f_np, mode)
                row = {"tensor": tstr, "rank": r, "mode": mode, "flops": flops, "devices": {}, "vs_oracle": {}}
                for name, (where, fn) in contenders(x_np, f_np, x_d, f_d, mode).items():
                    dt, out = timeit(fn, reps)
                    rel = rel_diff(out, oracle)
                    if rel > TOL:
                        raise AssertionError(f"{name} disagrees with oracle: {rel:g} ({tstr} rank {r} mode {mode})")
                    row[name + "_s"] = dt
                    row[name + "_gflops"] = flops / dt / 1e9
                    row["devices"][name] = where
                    row["vs_oracle"][name] = rel
                if f32 is not None:
                    for tier in FUSED_TIERS:
                        row.update(fused_row(x32, f32, mode, tier, reps, oracle, flops))
                        row["devices"][f"ours_fused_{tier}"] = dev.type
                rows.append(row)
                print(f"{tstr:>14} {r:>5} {mode:>4} "
                      + " ".join(f"{row[c + '_gflops']:>13.1f}" if c + "_gflops" in row else f"{'-':>13}"
                                 for c in CONTENDERS), flush=True)
                for tier in FUSED_TIERS if f32 is not None else ():
                    g = row[f"ours_fused_{tier}_gflops"]
                    print(f"{'':>25} fused {tier}: " + ("refused by the gate" if g is None else
                          f"{g:.1f} GFLOP/s, {row[f'ours_fused_{tier}_vs_plain']:.2e} of max|G| from its plain "
                          f"version, {row[f'ours_fused_{tier}_vs_f64']:.2e} from float64"), flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tensors", default="100-100-100,299-301-41")
    p.add_argument("--ranks", default="5,20,100")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda", help="where the port's routes run: cuda (the default) or cpu")
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    card = device_line(dev)
    print(card, flush=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        rows = run(args.tensors, args.ranks, args.reps, dev)
    finally:
        torch.set_num_threads(threads)
    summary = {
        "note": (
            "External MTTKRP comparison (analog of the reference's CTF/PLANC benchmark_other_mttkrp; torch, "
            "numpy and an independent C++/OpenMP implementation (native/mttkrp_ref.cpp) on the host's CPU stand "
            f"in for the external stacks; the port's routes on {dev.type}). fp64; min of {args.reps} reps; every "
            "fp64 contender verified against the NumPy oracle at 1e-10. On the card, fp32 rows of the fused "
            "kernels (B = 1) held to their plain versions at 2e-5 of max|G|."
        ),
        "cpus": os.cpu_count(),
        "device": dev.type if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        "card": card,
        "rows": rows,
    }
    path = write_json(args.out, "external_mttkrp.json", summary)
    print(f"wrote {path}")
    return summary


if __name__ == "__main__":
    main()
