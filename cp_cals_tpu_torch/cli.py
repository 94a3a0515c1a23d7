"""CLI demo driver (port of ``cp_cals_tpu/cli.py``).

Builds a random low-rank tensor and a batch of random models across a rank
range, fits them with concurrent CALS, optionally fits the same batch with
batched ALS and prints the speedup, and optionally jackknifes the best
model of each rank. The target tensor is the JAX CLI's (threefry keys,
``prng.py``); the models are drawn on the host from ``--seed``.

Usage:
  python -m cp_cals_tpu_torch.cli -t 100-100-100 -c 1:10:20 [--tol 1e-6]
      [--line-search] [--nnls] [--compare-als] [--jk] [--csv out.csv]
      [--tensor-file path] [--device cuda|cpu]

On several cards, one process each (torchrun sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT):
  torchrun --nproc_per_node=N -m cp_cals_tpu_torch.cli --distributed --dp N ...
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-t", "--tensor", default="100-100-100",
                   help="tensor modes, e.g. 299-301-41 (ignored with --tensor-file)")
    p.add_argument("-c", "--components", default="1:10:10",
                   help="MIN:MAX:COPIES rank range (reference driver.cpp -c flag)")
    p.add_argument("--rank", type=int, default=5, help="target tensor rank")
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-iterations", type=int, default=200)
    p.add_argument("--buffer-size", type=int, default=4200)
    p.add_argument("--line-search", action="store_true")
    p.add_argument("--nnls", action="store_true")
    p.add_argument("--bucket-threads", type=int, default=1,
                   help="host threads that run a wave's buckets, each on its own CUDA stream "
                        "(config.CalsParams.bucket_threads)")
    p.add_argument("--bucket-ranks", default=None,
                   help="comma list of bucket rank classes, e.g. 4,8,16")
    p.add_argument("--compare-als", action="store_true",
                   help="also run batched ALS and report speedup")
    p.add_argument("--jk", action="store_true",
                   help="jackknife the best model per rank after fitting")
    p.add_argument("--csv", default=None, help="write per-model results CSV")
    p.add_argument("--tensor-file", default=None,
                   help="load the target tensor from a reference-format text file, .npy or .npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="production fast tier: bf16 MTTKRP + mixed-tier "
                        "tol checks (every 5 iterations) + 2 polish sweeps")
    p.add_argument("--evict-batch", type=int, default=1,
                   help="defer the eviction sync until this many models "
                        "have converged (config.evict_batch)")
    p.add_argument("--mode-layouts", default="auto",
                   choices=("auto", "materialized", "recompute"),
                   help="per-mode tensor layouts held or derived in each "
                        "iteration (config.mode_layouts; auto = held where "
                        "they fit a quarter of the card's memory, or X fits "
                        "128 MB off the card; recompute otherwise)")
    p.add_argument("--epilogue", default="auto", choices=("auto", "fused", "xla"),
                   help="per-mode epilogue (config.epilogue)")
    p.add_argument("--dimtree", default="auto", choices=("auto", "on", "off"),
                   help="dimension-tree sweep: modes 1/2 share one "
                        "X x_0 A contraction (config.dimtree; 3-D only)")
    p.add_argument("--polish-tol", type=float, default=0.0,
                   help="polish converged models to convergence at full "
                        "precision (config.polish_tol; use with --fast)")
    p.add_argument("--wire", default=None, metavar="DTYPE",
                   help="result extraction wire dtype (float16/bfloat16): "
                        "halves device->host result bytes")
    p.add_argument("--dp", type=int, default=0,
                   help="shard the model batch over this many devices")
    p.add_argument("--tp", type=int, default=1,
                   help="shard tensor mode 0 over this many devices")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process: join the torch.distributed process group "
                        "(parallel.distributed.initialize, torchrun's variables) "
                        "before touching the device; one process per device: "
                        "nccl on the card, gloo with --device cpu")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; the card must be present) or cpu "
                        "(the kernels' plain PyTorch versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .parallel import distributed
    from .parallel.sharding import local_device

    if args.distributed:
        # Before the device is touched: every process joins one group
        # instead of running an independent single-process job.
        distributed.initialize(device=args.device)
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        print(f"host {rank}/{world}: {local_device(args.device)} / {world} devices")

    from .config import AlsParams, CalsParams, UpdateMethod
    from .device import resolve_device
    from .ktensor import random_ktensor, random_ktensor_host, to_tensor
    from .prng import normal, prng_key, split
    from .solvers import cp_batched_als, cp_cals, jk_cp_cals
    from .utils.timers import write_ktensor_results_csv

    dev = local_device(args.device) if args.distributed else resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    kx, kn, _ = split(prng_key(args.seed, dev), 3)

    if args.tensor_file:
        from .tensor_io import read_tensor

        x = torch.as_tensor(read_tensor(args.tensor_file), dtype=dtype, device=dev)
    else:
        modes = tuple(int(m) for m in args.tensor.split("-"))
        x = to_tensor(random_ktensor(kx, modes, args.rank, dtype=dtype))
        if args.noise:
            x = x + args.noise * torch.std(x, correction=0) * normal(kn, x.shape, dtype)
    modes = tuple(x.shape)

    try:
        rmin, rmax, copies = (int(v) for v in args.components.split(":"))
        if rmin < 1 or rmax < rmin or copies < 1:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"error: -c/--components must be MIN:MAX:COPIES with "
            f"1 <= MIN <= MAX and COPIES >= 1 (got {args.components!r})"
        )
    rng = np.random.default_rng(args.seed)
    np_dtype = np.float64 if args.f64 else np.float32
    queue = [
        random_ktensor_host(rng, modes, r, dtype=np_dtype)
        for r in range(rmin, rmax + 1)
        for _ in range(copies)
    ]

    update = UpdateMethod.NNLS if args.nnls else UpdateMethod.UNCONSTRAINED
    extra = {}
    if args.bucket_ranks:
        extra["bucket_ranks"] = tuple(int(r) for r in args.bucket_ranks.split(","))
    if args.fast and not args.f64:
        extra.update(mttkrp_precision="default", tol_check_interval=5, polish_iters=2)
    if args.wire:
        extra["result_wire_dtype"] = args.wire
    if args.polish_tol > 0:
        # Overrides --fast's polish_iters=2: with polish-to-convergence,
        # polish_iters is the sweep cap.
        extra["polish_tol"] = args.polish_tol
        extra["polish_iters"] = 25
    cals_params = CalsParams(
        tol=args.tol,
        max_iterations=args.max_iterations,
        buffer_size=args.buffer_size,
        line_search=args.line_search,
        update_method=update,
        bucket_threads=args.bucket_threads,
        evict_batch=args.evict_batch,
        mode_layouts=args.mode_layouts,
        dimtree=args.dimtree,
        epilogue=args.epilogue,
        **extra,
    )
    print(f"Tensor {modes}, {len(queue)} models, ranks {rmin}..{rmax}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Device: {name}")

    mesh = None
    if args.dp or args.tp > 1:
        from .parallel.sharding import make_mesh

        mesh = make_mesh(n_dp=args.dp or None, n_tp=args.tp, device=dev)
        print(f"Mesh: dp={mesh.n_dp} x tp={mesh.n_tp}")

    t0 = time.perf_counter()
    results, rep = cp_cals(x, queue, cals_params, device=dev, mesh=mesh, shard_mode0=args.tp > 1)
    cals_s = time.perf_counter() - t0
    mean_fit = sum(m.fit for m in rep.models) / len(rep.models)
    print(
        f"CALS: {cals_s:.3f}s, {len(queue) / cals_s:.2f} models/s, "
        f"mean fit {mean_fit:.6f}, "
        f"mean iters {sum(m.iters for m in rep.models) / len(rep.models):.1f}"
    )

    if args.csv and distributed.is_coordinator():
        write_ktensor_results_csv(args.csv, rep.models)
        print(f"wrote {args.csv}")

    if args.compare_als:
        als_params = AlsParams(
            tol=args.tol,
            max_iterations=args.max_iterations,
            line_search=args.line_search,
            update_method=update,
        )
        # Batched ALS per rank (one batch of same-rank models each).
        t0 = time.perf_counter()
        by_rank: dict[int, list] = {}
        for kt in queue:
            by_rank.setdefault(kt.rank, []).append(kt)
        for kts in by_rank.values():
            cp_batched_als(x, kts, als_params, device=dev)
        als_s = time.perf_counter() - t0
        print(f"Batched ALS: {als_s:.3f}s -> CALS speedup {als_s / cals_s:.2f}x")

    if args.jk:
        best = {}
        for m, kt in zip(rep.models, results):
            if m.rank not in best or m.approx_error < best[m.rank][0].approx_error:
                best[m.rank] = (m, kt)
        models = [kt for _, kt in best.values()]
        t0 = time.perf_counter()
        jk_rep = jk_cp_cals(x, models, cals_params, device=dev)
        jk_s = time.perf_counter() - t0
        n_reps = sum(len(r) for r in jk_rep.results)
        print(f"Jackknife: {n_reps} replicates in {jk_s:.3f}s")


if __name__ == "__main__":
    main()
