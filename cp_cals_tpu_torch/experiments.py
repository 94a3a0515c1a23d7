"""Experiment harness: the paper's workloads (port of
``cp_cals_tpu/experiments.py``).

Each experiment runs CALS against the ALS baselines on the same inputs,
cross-checks the errors, and writes the CSV schema of the reference's
analysis scripts (KTENSOR_ID;RANK;ERROR;ITERS): the ALS-vs-CALS grid
(``compare_als_cals``), the NNLS comparison, the jackknife and
jackknife-scale runs, the real-data jackknife of a tensor file, the
500^3 scale sweep, the defrag study and the matmul peak evaluator. The
functions, arguments, defaults, flags and result keys are the JAX
package's; every function also takes ``device`` (None: the CUDA card,
which must be present; "cpu" runs the kernels' plain PyTorch versions),
and ``dtype`` is a torch dtype.

Run:
  python -m cp_cals_tpu_torch.experiments [--out chiprun_out/experiments]
      [--quick] [--jk] [--jk-scale] [--scale-sweep] [--jk-file PATH]
      [--no-base] [--defrag] [--nnls] [--large] [--device cuda|cpu]

``experiments.json`` in ``--out`` is merged with the file's earlier keys,
so partial runs add to it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import launches, solvers
from .config import AlsParams, CalsParams, UpdateMethod, resolve_layouts
from .device import resolve_device
from .ktensor import Ktensor, RandomKtensorSpec, random_ktensor, random_ktensor_host, to_tensor
from .prng import normal, prng_key, split
from .utils.timers import write_ktensor_results_csv


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def make_workload(modes, rank_min, rank_max, copies, target_rank=5,
                  noise=0.05, dtype=torch.float32, seed=0, device=None):
    """A noisy rank-``target_rank`` target drawn on ``device`` from JAX's
    threefry keys (the CLI's draw: the population std scales the noise),
    and a host queue of ``copies`` random models per rank."""
    dev = resolve_device(device)
    kx, kn, _ = split(prng_key(seed, dev), 3)
    x = to_tensor(random_ktensor(kx, modes, target_rank, dtype=dtype))
    if noise:
        x = x + noise * torch.std(x, correction=0) * normal(kn, x.shape, dtype)
    rng = np.random.default_rng(seed)
    queue = [
        random_ktensor_host(rng, modes, r, dtype=_np_dtype(dtype))
        for r in range(rank_min, rank_max + 1)
        for _ in range(copies)
    ]
    return x, queue


def compare_als_cals(x, queue, cals_params, als_params, out_dir=None,
                     tag="run", check_tol=1e-1, warm=True, device=None):
    """CALS vs batched-ALS on identical inputs with error cross-checking
    (reference experiments_utils.cpp:69-193, tolerance 1e-1 + NaN screen).

    warm=True runs ``precompile_buckets`` (the nvcc build and the lookup
    table's misses) and each side once untimed first, as the JAX package
    does (the allocator's growth and the first graph captures). The timed
    CALS run still captures its graphs, as a user's second call does."""
    from .solvers.cals import precompile_buckets

    dev = resolve_device(device)
    if warm:
        precompile_buckets(x, queue, cals_params, device=dev)
        solvers.cp_cals(x, queue, cals_params, device=dev)
    t0 = time.perf_counter()
    _, rep = solvers.cp_cals(x, queue, cals_params, device=dev)
    cals_s = time.perf_counter() - t0

    by_rank: dict[int, list] = {}
    order: dict[int, list] = {}
    for i, kt in enumerate(queue):
        by_rank.setdefault(kt.rank, []).append(kt)
        order.setdefault(kt.rank, []).append(i)
    if warm:
        for kts in by_rank.values():
            solvers.cp_batched_als(x, kts, als_params, device=dev)
    t0 = time.perf_counter()
    als_errors = {}
    for r, kts in by_rank.items():
        _, reps = solvers.cp_batched_als(x, kts, als_params, device=dev)
        for i, rr in zip(order[r], reps):
            als_errors[i] = rr.approx_error
    als_s = time.perf_counter() - t0

    n_bad = 0
    for m in rep.models:
        e1, e2 = m.approx_error, als_errors[m.id]
        if not (abs(e1 - e2) <= check_tol * max(1.0, abs(e2))) or e1 != e1:
            n_bad += 1
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_ktensor_results_csv(os.path.join(out_dir, f"cals_{tag}.csv"), rep.models)
    return {
        "cals_s": cals_s,
        "als_s": als_s,
        "speedup": als_s / cals_s,
        "n_models": len(queue),
        "n_mismatched": n_bad,
    }


def peak_evaluator(dtype=torch.bfloat16, n=4096, reps=50, best_of=3, device=None):
    """Achievable matmul TFLOP/s (reference peak_evaluator.cpp): a chain of
    ``reps`` n x n products, each product the next left operand, the whole
    last product summed, so no product can be hoisted or dropped; the best
    of ``best_of`` chains, timed with CUDA events on the card.

    ``torch.float32`` is strict fp32 on the CUDA cores: TF32 is off
    (``device.py``), as at the port's "highest" tier, so
    ``peak_f32_tflops`` keeps its name and measures the card's CUDA-core
    fp32. bf16 runs on the tensor cores with float32 accumulation. The
    right operand is scaled by 1/sqrt(n), so the chain's values keep their
    size."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((n, n), generator=gen).to(device=dev, dtype=dtype)
    b = (torch.randn((n, n), generator=gen) / n**0.5).to(device=dev, dtype=dtype)

    def chain():
        aa = a
        for _ in range(reps):
            aa = torch.matmul(aa, b)
        return aa.float().sum()

    float(chain())  # warm: cuBLAS's plans, the allocator
    dt = float("inf")
    for _ in range(best_of):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = chain()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = chain()
            t = time.perf_counter() - t0
        if not torch.isfinite(out):
            raise FloatingPointError(f"peak_evaluator: the {dtype} chain overflowed")
        dt = min(dt, t / reps)
    return 2 * n**3 / dt / 1e12


def jackknife_experiment(modes=(50, 100, 100), ranks=(3, 5, 7, 9),
                         max_iter=50, dtype=torch.float32, device=None):
    """Reference paper §5 jackknife workload (experiments_jk.cpp:34-98):
    fit one model per rank, then jackknife all of them in one concurrent
    run; report replicate throughput."""
    dev = resolve_device(device)
    np_dtype = _np_dtype(dtype)
    rng = np.random.default_rng(0)
    kt = random_ktensor_host(rng, modes, max(ranks), dtype=np_dtype)
    x_np = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x_np += 0.05 * x_np.std() * rng.standard_normal(x_np.shape)
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)

    fit_params = CalsParams(
        tol=1e-6, max_iterations=max_iter, precision="high",
        bucket_ranks=(4, 8, 12),
    )
    models = [random_ktensor_host(rng, modes, r, dtype=np_dtype) for r in ranks]
    fitted, _ = solvers.cp_cals(x, models, fit_params, device=dev)

    jk_params = CalsParams(
        tol=1e-6, max_iterations=max_iter, precision="high",
        bucket_ranks=(4, 8, 12), buffer_size=4200,
    )
    solvers.jk_cp_cals(x, fitted, jk_params, device=dev)  # warm
    t0 = time.perf_counter()
    rep = solvers.jk_cp_cals(x, fitted, jk_params, device=dev)
    dt = time.perf_counter() - t0
    n = sum(len(r) for r in rep.results)
    return {"n_replicates": n, "wall_s": round(dt, 3),
            "replicates_per_sec": round(n / dt, 2)}


def jackknife_real_experiment(path, ranks=(4, 5, 6), tol=1e-6,
                              max_iter=1000, dtype=torch.float32, seed=0, device=None):
    """Reference §5.3 real-data JK protocol (experiments_jk.cpp:63-96 +
    compare_jk_als_cals_real, experiments_utils.cpp:417-526): load a
    tensor from the reference text format, fit one random-init model per
    requested component count tol-driven, jackknife them all in one
    concurrent CALS run, and cross-time the batched-ALS jackknife
    baseline on the same fitted models.

    The reference runs this on stjohns.txt / wine.txt (fluorescence EEM
    datasets it does not ship); any reference-format tensor file works.
    """
    from .tensor_io import read_tensor

    dev = resolve_device(device)
    x = torch.as_tensor(read_tensor(path), dtype=dtype, device=dev)
    rng = np.random.default_rng(seed)
    models = [random_ktensor_host(rng, tuple(x.shape), r, dtype=_np_dtype(dtype))
              for r in ranks]
    fit_params = CalsParams(
        tol=tol, max_iterations=max_iter, precision="high",
        bucket_ranks=tuple(sorted(set(ranks))),
    )
    fitted, fit_rep = solvers.cp_cals(x, models, fit_params, device=dev)

    solvers.jk_cp_cals(x, fitted, fit_params, device=dev)  # warm
    t0 = time.perf_counter()
    rep = solvers.jk_cp_cals(x, fitted, fit_params, device=dev)
    cals_s = time.perf_counter() - t0
    n = sum(len(r) for r in rep.results)

    als_params = AlsParams(tol=tol, max_iterations=max_iter,
                           precision="high")
    solvers.jk_cp_batched_als(x, fitted, als_params, device=dev)  # warm
    t0 = time.perf_counter()
    solvers.jk_cp_batched_als(x, fitted, als_params, device=dev)
    als_s = time.perf_counter() - t0

    return {
        "file": os.path.basename(path),
        "modes": list(x.shape),
        "ranks": list(ranks),
        "fits": [round(m.fit, 6) for m in fit_rep.models],
        "n_replicates": n,
        "jk_cals_s": round(cals_s, 3),
        "jk_batched_als_s": round(als_s, 3),
        "speedup": round(als_s / cals_s, 2),
    }


# The scale sweep's engine settings (bucket ranks, the bounded live-column
# budget whose waves stream the rest, the tier) and its queue's top rank; the
# tools that reckon its buckets read them from here.
SWEEP_SETTINGS = dict(bucket_ranks=(4, 8, 16, 20), buffer_size=40 * 96, precision="high", rank_max=20)


def scale_sweep(modes=(500, 500, 500), copies=250, rank_max=SWEEP_SETTINGS["rank_max"],
                max_iter=50, dtype=torch.float32, seed=7,
                mode_layouts="auto", device=None, return_run=False):
    """BASELINE.json config 5 (single-host leg): thousands of concurrent
    CPDs on one large synthetic tensor — copies models per rank 1..rank_max
    (250 copies -> 5000 models at the baseline's 500^3 size), forced
    iterations, models/s + achieved MTTKRP TFLOP/s (the padded columns'
    ALS FLOPs over the wall).

    ``warmup_s`` times ``precompile_buckets`` (the kernels' build, each
    bucket's table resolution and the norm prologue). ``lut_dispatch`` counts the table's
    decisions (``utils/lut.LOOKUP_STATS``) over the warm-up and the run.
    ``hbm_measured`` (on the card only) reads the caching allocator after
    the run: the bytes allocated now and at the peak since the run began
    (the captured graphs' pools included), and the card's memory.
    ``return_run`` returns (the result, cp_cals's results, its report).
    """
    from .ops.mttkrp import als_iteration_flops
    from .solvers.cals import bucket_rank, precompile_buckets
    from .utils import lut

    dev = resolve_device(device)
    np_dtype = _np_dtype(dtype)
    rng = np.random.default_rng(seed)
    # Large random tensor built host-side in one shot; low-rank structure
    # is irrelevant under force_max_iter (reference experiments also use
    # T.randomize() for the throughput protocol, experiments_jk.cpp:57).
    x = torch.as_tensor(rng.standard_normal(modes).astype(np_dtype), device=dev)
    queue = [
        RandomKtensorSpec(tuple(modes), r, seed=1000 * r + c, dtype=np_dtype.name)
        for r in range(1, rank_max + 1) for c in range(copies)
    ]
    params = CalsParams(
        tol=1e-6, max_iterations=max_iter, force_max_iter=True,
        precision=SWEEP_SETTINGS["precision"], bucket_ranks=SWEEP_SETTINGS["bucket_ranks"],
        buffer_size=SWEEP_SETTINGS["buffer_size"], mode_layouts=mode_layouts,
    )
    lut.reset_lookup_stats()
    t0 = time.perf_counter()
    precompile_buckets(x, queue, params, device=dev)
    warm_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    results, rep = solvers.cp_cals(x, queue, params, device=dev)
    wall = time.perf_counter() - t0
    padded_flops = sum(
        m.iters * als_iteration_flops(modes, bucket_rank(m.rank, params.bucket_ranks))
        for m in rep.models
    )
    out = {
        "modes": list(modes), "n_models": len(queue),
        "mode_layouts": mode_layouts,
        "warmup_s": round(warm_s, 3), "wall_s": round(wall, 3),
        "models_per_sec": round(len(queue) / wall, 2),
        "mttkrp_tflops": round(padded_flops / wall / 1e12, 2),
        "lut_dispatch": dict(lut.LOOKUP_STATS),
    }
    # HBM accounting, policy-aware: under "materialized" the N per-mode
    # layouts are the dominant residents (N x |X|); under "recompute" they
    # are derived in-loop and at most ONE transient layout is live at a
    # time. "auto" resolves as the engine does (config.resolve_layouts).
    itemsize = np_dtype.itemsize
    x_bytes = int(np.prod(modes)) * itemsize
    resolved = resolve_layouts(params, x, dev)
    out["mode_layouts_resolved"] = resolved
    out["hbm_model_bytes"] = {
        "tensor": x_bytes,
        "prepared_layouts_resident": (
            len(modes) * x_bytes if resolved == "materialized" else x_bytes
        ),
        "bucket_states_approx": int(
            3 * params.buffer_size * max(modes) * itemsize
        ),
    }
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        out["hbm_measured"] = {
            "bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
        }
    return (out, results, rep) if return_run else out


def defrag_experiment(modes=(200, 200, 200), rank_max=20, copies=20,
                      max_iter=1000, out_dir=None, dtype=torch.float32, device=None):
    """Reference 'letter' defrag-stress study (experiments_letter.cpp:33-51):
    random 200^3 tensor, 20 models per rank 1..20, ``always_evict_first`` —
    the leftmost occupied slot is force-evicted every iteration, maximizing
    occupancy churn. In the reference this stresses buffer defragmentation;
    here it stresses per-iteration slot refill (the engine's analog, which
    runs ``graph_loop.IterLoop``). The run is compared against the default
    eviction policy on the same inputs.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(modes), dtype=dtype, device=dev)
    queue = [
        random_ktensor_host(rng, modes, r, dtype=_np_dtype(dtype))
        for r in range(1, rank_max + 1)
        for _ in range(copies)
    ]
    base = dict(
        tol=1e-6, max_iterations=max_iter, precision="high",
        bucket_ranks=(4, 8, 12, 16, 20),
    )
    out = {}
    for tag, evict_first in (("defrag", True), ("default", False)):
        params = CalsParams(always_evict_first=evict_first, **base)
        solvers.cp_cals(x, queue, params, device=dev)  # warm
        t0 = time.perf_counter()
        _, rep = solvers.cp_cals(x, queue, params, device=dev)
        dt = time.perf_counter() - t0
        out[tag] = {
            "wall_s": round(dt, 3),
            "models_per_sec": round(len(queue) / dt, 2),
            "mean_iters": round(
                sum(m.iters for m in rep.models) / len(rep.models), 2
            ),
        }
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            write_ktensor_results_csv(
                os.path.join(out_dir, f"defrag_{tag}.csv"), rep.models
            )
    out["evict_first_overhead"] = round(
        out["defrag"]["wall_s"] / out["default"]["wall_s"], 3
    )
    return out


def nnls_workload(quick=False, device=None):
    """The NNLS comparison's inputs and params (``main --nnls``): a
    non-negative target (the reference fits fluorescence data, which is
    non-negative; synthetic equivalent: the absolute values of a rank-5
    Ktensor drawn from JAX's threefry key 1), a host queue of random models
    (ranks 1-10 x 10; 1-3 x 2 with ``quick``), and CALS and ALS params at
    "high" with block principal pivoting, forced iterations."""
    dev = resolve_device(device)
    nn_modes = (30, 30, 30) if quick else (100, 100, 100)
    kt_true = random_ktensor(prng_key(1, dev), nn_modes, 5, dtype=torch.float32)
    x_nn = to_tensor(Ktensor(tuple(f.abs() for f in kt_true.factors), kt_true.lam.abs()))
    rng = np.random.default_rng(1)
    queue_nn = [
        random_ktensor_host(rng, nn_modes, r, dtype=np.float32)
        for r in range(1, (3 if quick else 10) + 1)
        for _ in range(2 if quick else 10)
    ]
    nn_cals = CalsParams(
        max_iterations=5 if quick else 50,
        force_max_iter=True,
        update_method=UpdateMethod.NNLS,
        bucket_ranks=(4, 8, 12),
        precision="high",
    )
    nn_als = AlsParams(
        max_iterations=nn_cals.max_iterations,
        force_max_iter=True,
        update_method=UpdateMethod.NNLS,
        # Match the CALS matmul precision: NNLS active-set decisions are
        # discrete, so a precision mismatch flips passive sets and sends
        # models to different local minima (n_mismatched != 0 that says
        # nothing about CALS correctness).
        precision=nn_cals.precision,
    )
    return x_nn, queue_nn, nn_cals, nn_als


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them; "cpu" off the
    card."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _counts_line(tag: str) -> None:
    """The kernel launches and MTTKRP results by route of the leg just run
    (``launches.py``), then every count back to 0."""
    print(f"{tag} launches {launches.read()} routes {launches.routes()}", flush=True)
    launches.reset()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join("chiprun_out", "experiments"))
    p.add_argument("--quick", action="store_true")
    p.add_argument("--jk", action="store_true",
                   help="also run the jackknife experiment (paper §5)")
    p.add_argument("--jk-scale", action="store_true",
                   help="jackknife scale sweep over the paper's tensor "
                        "sizes 50x{100,200,400}^2 (experiments_jk.cpp:34-98)")
    p.add_argument("--scale-sweep", action="store_true",
                   help="BASELINE config 5 single-host leg: 5000 concurrent "
                        "CPDs (ranks 1-20 x 250) on a synthetic 500^3 "
                        "tensor; --quick shrinks it")
    p.add_argument("--jk-file", default=None,
                   help="real-data jackknife (reference §5.3, "
                        "experiments_jk.cpp:63-96): path to a "
                        "reference-format tensor text file")
    p.add_argument("--jk-file-ranks", default="4,5,6",
                   help="component counts for --jk-file (reference uses "
                        "4,5,6 for stjohns and 20,20,20 for wine)")
    p.add_argument("--no-base", action="store_true",
                   help="skip the base ALS-vs-CALS size sweep (useful when "
                        "running a single named experiment)")
    p.add_argument("--defrag", action="store_true",
                   help="also run the defrag/letter study "
                        "(experiments_letter.cpp)")
    p.add_argument("--nnls", action="store_true",
                   help="also run the non-negative (NNLS) comparison "
                        "(reference paper 6.3 uses constrained updates)")
    p.add_argument("--large", action="store_true",
                   help="include the 300^3 size (the reference's full §6.1 "
                        "grid is 100/200/300^3, experiments.cpp:58-150); "
                        "ignored with --quick")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; the card must be present) or cpu "
                        "(the kernels' plain PyTorch versions)")
    args = p.parse_args(argv)

    from .utils.roofline import device_peaks

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    results = {"device": device_line(dev)}
    print(results["device"], flush=True)

    # JAX's chain on the card; a short one on the CPU, whose rate is no
    # device figure.
    peak_size = dict(n=4096, reps=50) if dev.type == "cuda" else dict(n=256, reps=3)
    results["peak_bf16_tflops"] = round(peak_evaluator(torch.bfloat16, device=dev, **peak_size), 2)
    results["peak_f32_tflops"] = round(peak_evaluator(torch.float32, device=dev, **peak_size), 2)
    sheet = device_peaks(dev)
    for key, kind in (("peak_bf16_tflops", "bf16"), ("peak_f32_tflops", "fp32")):
        ref = f"data sheet {sheet[kind + '_tflops']} TFLOP/s, measured {results[key] / sheet[kind + '_tflops']:.3f} of it" \
            if sheet else "no data-sheet peak for this device"
        print(f"{key} {results[key]} ({ref})", flush=True)
    launches.reset()

    # Paper §6.1-style: 20 models/rank, forced 50 iterations.
    sizes = [(50, 50, 50)] if args.quick else [(100, 100, 100), (200, 200, 200)]
    if args.no_base:
        sizes = []
    if args.large:
        if args.quick:
            print("--large ignored with --quick", file=sys.stderr)
        else:
            sizes.append((300, 300, 300))
    copies = 2 if args.quick else 20
    rmax = 3 if args.quick else 20
    for modes in sizes:
        x, queue = make_workload(modes, 1, rmax, copies, device=dev)
        cals_p = CalsParams(
            max_iterations=5 if args.quick else 50,
            force_max_iter=True,
            bucket_ranks=(4, 8, 12, 16, 20),
        )
        als_p = AlsParams(
            max_iterations=cals_p.max_iterations, force_max_iter=True
        )
        tag = "x".join(map(str, modes))
        results[tag] = compare_als_cals(
            x, queue, cals_p, als_p, out_dir=args.out, tag=tag, device=dev
        )
        print(tag, results[tag], flush=True)
        _counts_line(tag)

    if args.nnls:
        x_nn, queue_nn, nn_cals, nn_als = nnls_workload(args.quick, dev)
        results["nnls"] = compare_als_cals(
            x_nn, queue_nn, nn_cals, nn_als, out_dir=args.out, tag="nnls", device=dev
        )
        print("nnls", results["nnls"], flush=True)
        _counts_line("nnls")

    if args.jk:
        jk_modes = (20, 30, 30) if args.quick else (50, 100, 100)
        results["jackknife"] = jackknife_experiment(
            modes=jk_modes, max_iter=10 if args.quick else 50, device=dev
        )
        print("jackknife", results["jackknife"], flush=True)
        _counts_line("jackknife")

    if args.jk_scale:
        # Paper §5 scale sweep (experiments_jk.cpp:34-98: synthetic
        # 50x{100,200,400}^2, ranks {3,5,7,9}, one concurrent JK run each).
        sweep = {}
        dims = (100,) if args.quick else (100, 200, 400)
        for d in dims:
            tag = f"50x{d}x{d}"
            sweep[tag] = jackknife_experiment(
                modes=(50, d, d), max_iter=10 if args.quick else 50, device=dev
            )
            print("jk_scale", tag, sweep[tag], flush=True)
            _counts_line(f"jk_scale {tag}")
        results["jackknife_scale"] = sweep

    if args.scale_sweep:
        if args.quick:
            results["scale_sweep"] = scale_sweep(
                modes=(30, 25, 20), copies=3, rank_max=6, max_iter=5, device=dev
            )
        else:
            results["scale_sweep"] = scale_sweep(device=dev)
        print("scale_sweep", results["scale_sweep"], flush=True)
        _counts_line("scale_sweep")

    if args.jk_file:
        ranks = tuple(int(r) for r in args.jk_file_ranks.split(","))
        results["jackknife_real"] = jackknife_real_experiment(
            args.jk_file, ranks=ranks,
            max_iter=50 if args.quick else 1000, device=dev,
        )
        print("jk_real", results["jackknife_real"], flush=True)
        _counts_line("jk_real")

    if args.defrag:
        if args.quick:
            results["defrag"] = defrag_experiment(
                modes=(30, 30, 30), rank_max=4, copies=2, max_iter=5,
                out_dir=args.out, device=dev,
            )
        else:
            results["defrag"] = defrag_experiment(out_dir=args.out, device=dev)
        print("defrag", results["defrag"], flush=True)
        _counts_line("defrag")

    # Merge into any existing results file: partial invocations (--jk only,
    # --nnls only, ...) must not clobber keys from earlier full runs.
    out_path = os.path.join(args.out, "experiments.json")
    merged = {}
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                merged = json.load(f)
        except json.JSONDecodeError:
            merged = {}
    merged.update(results)
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
