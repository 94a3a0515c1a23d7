#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cp_cals_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (none catches another's failure; any failure exits non-zero before
the result lines are printed):

1. The card: its name and power limit as nvidia-smi reports them, and the
   torch and CUDA versions.
2. Build: the CUDA kernels compile from cp_cals_tpu_torch/csrc/ (nvcc, one
   process per source, in parallel).
3. Kernels: at every (bucket batch B, bucket rank R) the engine allocates
   for the bench workload (299x301x41, buffer_size=2880) and every mode,
   each kernel is held against its plain PyTorch version on the card on the
   same inputs, and kernel, plain version and one PyTorch yardstick call are
   timed with CUDA events. The MTTKRP runs at every tier on that tier's held
   layout of X: "highest" through the fp32 kernel, "high" and "default"
   through the tensor-core kernel. The normal inverse is held on the engine's own
   normal matrices: a bucket of bench-workload models run through the
   port's iteration on the card. The apply is held on every mode with and
   without the FastALS error it finishes on the last mode, and timed as
   the iteration calls it (the error on mode 2). The fp32 MTTKRP is also
   timed against the torch twostep replayed from a CUDA graph.
4. Engine: cp_cals on the full bench workload (400 models, ranks 1-20 x 20,
   buckets 4/8/12/16/20, 10 forced iterations) through the kernels, at the
   "highest" tier and then at the bench tiers (precision="high",
   mttkrp_precision="default"). Each run starts with every launch count at
   0, and each kernel of its path (the MTTKRP kernel of its tier) must have
   launched 3 x the bucket-iterations the engine ran, every other kernel
   not at all. In both runs 20 models (one of each rank) are cross-checked
   against the port's own float64 run on the CPU from the same inits.
5. Jackknife, at full width (the JAX bench's jackknife configuration): a
   rank-5 model of the bench tensor fitted by cp_als on the card, then its
   299 leave-one-out replicates in one bucket of rank 8 (B = 320): J1
   jk_cp_cals as pinned (fused epilogue); J2 the same with
   solve_method="pallas" (unfused epilogue through the SPD-inverse kernel);
   J3 jk_cp_batched_als with solve_method="pallas" (one bucket of rank 5).
   Each run starts with every count at 0 and must launch exactly its
   path's kernels 3 x its bucket-iterations; each returns 299 replicates
   with factor 0 NaN on exactly its fiber's row. J1's MTTKRP calls are
   recorded, and the tensor-core kernel is held against its plain version
   and timed on J1's own inputs at each (B, mode) of J1's launch mix.
   J1 and J2 are run again at
   10 forced iterations and 10 fibers are cross-checked against the port's
   float64 CPU run.
6. SPD inverse: the kernel against its plain version on the normal
   matrices J2 inverted, and on random SPD batches (R = 4, 20, 32, 33, 64,
   cond up to 1e4, dead identity slots), timed at J2's launch mix. Both
   inverses record which path of their shared elimination (warp or block)
   each shape took.
7. Probe: the launch-overhead probe (cp_cals_tpu_torch/probe_overhead.py),
   eager and graph-captured; its copy kernel is held to exact equality.
8. Result: one {"kernels": [...]} line, then the last line
   {"ok": true, "device": {...}}. The per-shape measurements go to
   chiprun_out/chip_smoke.json, the probe's to
   chiprun_out/overhead_probe.json.

The kernels' "ms", "graph_ms", "plain_ms", "bound_ms" and "library_ms" in
the result line are per-launch means over a launch mix: the "highest"
engine run's for the fp32 MTTKRP, the bench-tier run's for the tensor-core
MTTKRP and the fused epilogue (each (bucket, mode) weighted by that
bucket's engine iterations), J2's for the SPD inverse, and the probe's two
shapes for the copy kernel. "ms" is a launch's share of 20 eager launches
back to back (for a small kernel mostly the host's cost of issuing it),
"graph_ms" its share of 20 launches replayed from one CUDA graph (the
device's time).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

MODES = (299, 301, 41)
BUCKETS = (4, 8, 12, 16, 20)
BUFFER = 2880
ITERS = 10
TIERS = ("highest", "high", "default")
BENCH_TIERS = dict(precision="high", mttkrp_precision="default")

# Tolerances of kernel against plain version, relative to the largest
# magnitude of the plain result (fp32, eps = 6e-8):
# - MTTKRP: sums of J*K <= 90,000 products per output, in another order
#   than cuBLAS; the rounding walk is ~sqrt(J*K)*eps*max|G| ~ 2e-5*max|G|
#   at worst, and the tier's bf16 roundings are the same in both versions.
# - hinv: unpivoted Gauss-Jordan in both, division and FMA placement
#   differ, so per model the difference grows as cond(H) * eps: it is held
#   per model to TOL["hinv"] * cond(H) * max|H^-1|, cond(H) in float64.
#   The engine's normal matrices reach cond(H) ~ 2e4 and read at most
#   8.4e-8 on an H100; the first-order inverse 2I - H reads 3.6e-4 or more
#   wherever it is not exact, and a kernel that skipped the pivot division
#   would read about 1 / cond(H) >= 5e-5.
# - apply: R-term dot products and I-term gramian sums in fp32: F, lam and
#   the rescaled gramian at 1e-5. The error, per model relative: F and the
#   gramian differ from the plain version's at fp32 rounding (a few 1e-7
#   relative), and err^2 = |X|^2 + term2 - 2 term3 carries that through its
#   double-float sums, amplified by the cancellation (|X|^2 + ...) / err^2,
#   under 10 at these inputs (err is near |X| for unfitted factors) and
#   about 30 at the engine's fits of 0.81: 1e-5, like the rest.
# The SPD inverse is held like hinv (the same elimination with a reciprocal
# of each pivot): on J2's normal matrices (cond <= 1.1e4) and random batches
# up to cond 1e4 it read at most 7.9e-8 on an H100.
TOL = {"mttkrp": 2e-5, "hinv": 1e-6, "apply": 1e-5, "apply_err": 1e-5}
# Engine against the port's float64 CPU run (20 models, 10 iterations from
# the same inits): the largest |fit difference| and relative reconstruction
# difference allowed, per run. Both runs are deterministic; on an H100 they
# read 5.1e-6 / 8.2e-6 ("highest") and 1.6e-3 / 1.2e-3 (bench tiers, whose
# bf16 MTTKRP inputs carry 2^-9 relative rounding).
CROSS_TOL = {"highest": (5e-5, 5e-5), "bench-tiers": (1e-2, 1e-2)}
HINV_SNAPSHOTS = (1, 4, ITERS)  # engine iterations whose grams are checked
# The jackknife phase: the bench tensor's rank-5 model (fitted from this
# seed), its 299 replicates in one bucket of rank 8 (B = 320 slots).
JK_RANK, JK_BUCKET, JK_SEED = 5, 8, 17
# Rescaled, LSAP-adjusted replicates after 10 forced iterations on the card
# ("high" tier, float16 result wire) against the port's float64 CPU run of
# the same 10 fibers: the largest relative reconstruction difference (NaN
# row dropped) and the largest relative |lam| difference allowed. Both runs
# are deterministic; on an H100 J1 and J2 both read 3.2e-4 and 7.6e-5 (the
# float16 wire's 2^-11 rounding of the factors dominates).
JK_CROSS_TOL = (2e-3, 5e-4)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Per-launch device time of ``fn``: ``reps`` calls captured once in a
    CUDA graph and replayed, so the host's issue cost (Python, ctypes,
    allocation) is paid once per replay and not once per launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture (build, plan, allocator)
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """The least time for the work: operations over the peak rate of their
    type, or bytes (inputs read once, outputs written once) over HBM."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> tuple[float, float]:
    err = (got.double() - want.double()).abs().max().item()
    return err, want.abs().max().item()


def bench_tensor():
    """The bench workload's tensor: rank-5 model + 5% noise, seed 42."""
    from cp_cals_tpu_torch import random_ktensor_host

    rng = np.random.default_rng(42)
    kt = random_ktensor_host(rng, MODES, 5, dtype=np.float32)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = x + 0.05 * x.std() * rng.standard_normal(x.shape)
    return x.astype(np.float32), rng


# ------------------------------------------------------------ kernel phase


def twostep(x_ts, u1, u2, tier: str):
    """The MTTKRP's PyTorch yardstick: the unfused twostep at the tier, one
    cuBLAS GEMM of the [I*J, K] unfolding by U2 (bf16 inputs at the bf16
    tiers, three GEMMs of the hi/lo split at "high"), then the U1
    contraction."""
    b, j, r = u1.shape
    k = u2.shape[1]
    i = x_ts.shape[0] // j
    ub = u2.permute(1, 0, 2).reshape(k, b * r)
    if tier == "highest":
        t = torch.matmul(x_ts, ub)
    else:
        xh, uh = x_ts.to(torch.bfloat16), ub.to(torch.bfloat16)
        t = torch.matmul(xh, uh).float()
        if tier == "high":
            xl = (x_ts - xh.float()).to(torch.bfloat16)
            ul = (ub - uh.float()).to(torch.bfloat16)
            t = t + torch.matmul(xh, ul).float() + torch.matmul(xl, uh).float()
    return torch.einsum("njbr,bjr->bnr", t.view(i, j, b, r), u1)


def random_bucket(gen, b: int, r: int, dev):
    """Normalized random factors of one bucket: true ranks spread over
    r-3..r (padded columns zero), jackknife fibers on some slots, and the
    last slot dead (rank mask all False, zero factors)."""
    true = torch.tensor([max(1, r - (s % 4)) for s in range(b)])
    true[-1] = 0
    mask = (torch.arange(r)[None, :] < true[:, None]).to(dev)
    factors = []
    for m in MODES:
        f = (torch.rand(b, m, r, generator=gen) * 2 - 1).to(dev) * mask[:, None, :]
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=1, keepdim=True), min=1e-30)
        factors.append(f.contiguous())
    jk = torch.where(torch.arange(b) % 5 == 1, torch.arange(b) % 7, -1)
    return factors, mask, jk.to(torch.int32).to(dev)


def engine_grams(x, b: int, r: int, rng, dev):
    """The normal-matrix inputs the main path gives the normal inverse at
    (B, R): B - 1 bench-workload models of the bucket's ranks (R-3..R) and
    one dead slot, iterated by the port's own iteration on the card. Returns
    the rank mask and [(iteration, grams)] at HINV_SNAPSHOTS."""
    from cp_cals_tpu_torch import Ktensor, random_ktensor_host
    from cp_cals_tpu_torch.solvers.iteration import make_iteration
    from cp_cals_tpu_torch.solvers.state import init_state

    ranks = [max(1, r - s % 4) for s in range(b - 1)] + [0]
    parts = [np.zeros((b, m, r), np.float32) for m in MODES]
    lam = np.zeros((b, r), np.float32)
    for s, rk in enumerate(ranks[:-1]):
        kt = random_ktensor_host(rng, MODES, rk, dtype=np.float32)
        for dst, f in zip(parts, kt.factors):
            dst[s, :, :rk] = f
        lam[s, :rk] = kt.lam
    mask = torch.from_numpy(np.arange(r)[None, :] < np.array(ranks)[:, None]).to(dev)
    kt = Ktensor(tuple(torch.from_numpy(p).to(dev) for p in parts), torch.from_numpy(lam).to(dev))
    x_norm = torch.linalg.vector_norm(x.reshape(-1))
    state = init_state(kt, x_norm, rank_mask=mask, alive=mask.any(1))
    iteration = make_iteration(bench_params())
    prepared = iteration.prepare(x)
    snaps = []
    for it in range(1, max(HINV_SNAPSHOTS) + 1):
        state = iteration(x, state, x_norm, prepared)
        if it in HINV_SNAPSHOTS:
            snaps.append((it, state.grams))
    return mask, snaps


def hinv_reading(got, want, h) -> dict:
    """Per model: the kernel's difference from the plain version over
    cond(H) * max|H^-1|, the quantity TOL["hinv"] bounds."""
    h64 = h.double()
    cond = torch.linalg.cond(h64)
    err = (got.double() - want.double()).abs().amax((1, 2))
    scale = want.double().abs().amax((1, 2))
    ratio = err / (cond * scale)
    exact = torch.linalg.inv(h64)
    ex_scale = exact.abs().amax((1, 2))
    return dict(
        ratio=ratio.max().item(), cond_max=cond.max().item(), cond_min=cond.min().item(),
        max_abs_err=err.max().item(), ref_max=scale.max().item(),
        # each version's distance from the float64 inverse, relative
        kernel_vs_exact=((got.double() - exact).abs().amax((1, 2)) / ex_scale).max().item(),
        plain_vs_exact=((want.double() - exact).abs().amax((1, 2)) / ex_scale).max().item(),
    )


def cancelling_norms(g, hinv, iters, jk, zero_jk, gram_a, gram_b):
    """Model norms for the apply's error check: |X|^2 = 2 term3 - term2 +
    0.035 (|term2| + 2 |term3|), the terms of the plain version's error in
    float64, so that err^2 is 3.5 % of their size (0 for a dead slot)."""
    from cp_cals_tpu_torch.ops import fused_epilogue as fe

    f, lam, gm, _ = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk)
    lam, h = lam.double(), (gram_a.double() * gram_b.double() * gm.double())
    t2 = torch.einsum("bi,bj,bij->b", lam, lam, h)
    t3 = torch.einsum("bc,bic,bic->b", lam, f.double(), g.double())
    xn2 = 2 * t3 - t2 + 0.035 * (t2.abs() + 2 * t3.abs())
    return torch.sqrt(xn2.clamp(min=0)).float()


def inverse_path(b: int, r: int) -> str:
    """The path (warp or block, csrc/gj_elim.cuh) both inverse kernels take
    at (B, R), as the built library plans it; its Python mirror must agree."""
    from cp_cals_tpu_torch.ops import spd_inverse as si

    plan = si.built_plan(b, r)
    if plan != si.gj_plan(b, r):
        raise AssertionError(f"inverse launch plan at B={b} R={r}: built {plan}, mirror {si.gj_plan(b, r)}")
    return plan.path


def kernel_phase(x, dev):
    from cp_cals_tpu_torch.ops import fused_epilogue as fe
    from cp_cals_tpu_torch.ops import fused_mttkrp as fm
    from cp_cals_tpu_torch.ops.gramians import gramians, hadamard_but_one
    from cp_cals_tpu_torch.ops.update import padded_hadamard
    from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches

    (alloc,) = allocate_bucket_batches({r: 80 for r in BUCKETS}, BUFFER)
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(11)
    rows, worst = [], {"hinv": 0.0, "apply": 0.0, "apply_err": 0.0}
    x_norm_full = torch.linalg.vector_norm(x.reshape(-1))
    for r, b in sorted(alloc.items()):
        factors, mask, jk = random_bucket(gen, b, r, dev)
        grams = gramians(factors)
        e_mask, snaps = engine_grams(x, b, r, rng, dev)
        for mode in range(3):
            small, big = fm.split_others(MODES, mode)
            j, i, k = MODES[small], MODES[mode], MODES[big]
            u1, u2 = factors[small], factors[big]
            x_ts = x.permute(mode, small, big).reshape(-1, k)
            row = dict(B=b, R=r, mode=mode, J=j, I=i, K=k, mttkrp={})
            flops = 2 * j * i * k * b * r + 2 * j * i * b * r
            for tier in TIERS:
                # The tier's held layout: fp32 X at "highest", bf16 X (2 bytes
                # an element) at "default", the bf16 hi/lo pair (4) at "high".
                x3 = fm.prepare_mode_tensor(x, mode, tier)
                nbytes = x3.nbytes + 4 * b * (j + k + i) * r
                got = fm.fused_mttkrp(x3, u1, u2, tier)
                want = fm.fused_mttkrp_plain(x3, u1, u2, tier)
                torch.cuda.synchronize()
                err, scale = rel_err(got, want)
                if not err <= TOL["mttkrp"] * scale:
                    raise AssertionError(f"fused_mttkrp {tier} B={b} R={r} mode={mode}: {err} vs {scale}")

                def library(tier=tier):
                    return twostep(x_ts, u1, u2, tier)

                lib_err, _ = rel_err(library(), want)
                peak = PEAK_FP32 if tier == "highest" else PEAK_BF16
                row["mttkrp"][tier] = dict(
                    **bound(flops * (3 if tier == "high" else 1), peak, nbytes),
                    max_abs_err=err, ref_max=scale, library_err=lib_err,
                    ms=cuda_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
                    graph_ms=graph_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
                    plain_ms=cuda_ms(lambda: fm.fused_mttkrp_plain(x3, u1, u2, tier)),
                    library_ms=cuda_ms(library),
                )
                if tier == "highest":  # the fp32 kernel against the twostep, both replayed
                    row["mttkrp"][tier]["library_graph_ms"] = graph_ms(library)
            g = fm.fused_mttkrp(fm.prepare_mode_tensor(x, mode), u1, u2, "highest")
            checks = []
            for it, e_grams in snaps:
                got = fe.normal_inverse(e_grams, e_mask, mode)
                want = fe.normal_inverse_plain(e_grams, e_mask, mode)
                h = padded_hadamard(hadamard_but_one(e_grams, mode), e_mask)
                reading = hinv_reading(got, want, h)
                if not reading["ratio"] <= TOL["hinv"]:
                    raise AssertionError(f"normal_inverse B={b} R={r} mode={mode} iteration {it}: {reading}")
                # The check has teeth: the first-order inverse 2I - H fails it.
                eye = torch.eye(r, device=dev).expand_as(h)
                if hinv_reading(2 * eye - h, want, h)["ratio"] <= TOL["hinv"]:
                    raise AssertionError(f"normal_inverse B={b} R={r} mode={mode}: 2I - H passes the check")
                checks.append(dict(iteration=it, **reading))
                worst["hinv"] = max(worst["hinv"], reading["max_abs_err"])
            hinv = fe.normal_inverse(grams, mask, mode)  # the apply check's input
            row["hinv"] = dict(
                **bound(b * (4 * r**3 + 5 * r * r), PEAK_FP32, 4 * 3 * b * r * r + b * r),
                path=inverse_path(b, r), max_abs_err=max(c["max_abs_err"] for c in checks),
                ratio=max(c["ratio"] for c in checks),
                cond_max=max(c["cond_max"] for c in checks), checks=checks,
                ms=cuda_ms(lambda: fe.normal_inverse(e_grams, e_mask, mode)),
                graph_ms=graph_ms(lambda: fe.normal_inverse(e_grams, e_mask, mode)),
                plain_ms=cuda_ms(lambda: fe.normal_inverse_plain(e_grams, e_mask, mode)),
                library_ms=cuda_ms(lambda: torch.linalg.inv(h)),
            )
            # The apply on every mode, with and without the error it finishes
            # on the last mode (the bucket's other gramians), at iterations 1
            # and 4, with and without the JK zero. Each model's norm is set so
            # that err^2 = |X|^2 + term2 - 2 term3 is 3.5 % of |term2| +
            # 2 |term3|: the cancellation of the engine's error at fits near
            # 0.81, which random factors and the bench tensor's |X| would not
            # show (there err is |X| to fp32 rounding).
            errs, err_errs = [], []
            for iters_val in (1, 4):
                iters = torch.full((b,), iters_val, dtype=torch.int32, device=dev)
                for zero_jk in (False, True):
                    x_norm = cancelling_norms(g, hinv, iters, jk, zero_jk, grams[0], grams[1])
                    for with_err in (False, True):
                        err_inputs = (x_norm, grams[0], grams[1]) if with_err else None
                        got = fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)
                        want = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk, err_inputs)
                        torch.cuda.synchronize()
                        for a, w in zip(got[:3], want[:3]):
                            err, scale = rel_err(a, w)
                            if not err <= TOL["apply"] * max(scale, 1e-30):
                                raise AssertionError(
                                    f"epilogue_apply B={b} R={r} mode={mode} iters={iters_val} "
                                    f"zero_jk={zero_jk} with_err={with_err}: {err} vs {scale}")
                            errs.append(err)
                        if with_err:
                            e_rel = ((got[3].double() - want[3].double()).abs()
                                     / want[3].double().abs().clamp(min=1e-30)).max().item()
                            if not e_rel <= TOL["apply_err"]:
                                raise AssertionError(
                                    f"epilogue_apply error B={b} R={r} mode={mode} iters={iters_val} "
                                    f"zero_jk={zero_jk}: relative {e_rel}")
                            err_errs.append(e_rel)
                        if not (got[0][-1].eq(0).all() and got[1][-1].eq(0).all() and got[2][-1].eq(0).all()):
                            raise AssertionError("epilogue_apply: the dead slot is not inert")
            worst["apply"] = max(worst["apply"], max(errs))
            worst["apply_err"] = max(worst["apply_err"], max(err_errs))
            # Time the apply as the iteration calls it on this mode: with the
            # error on the last mode.
            iters = torch.full((b,), 4, dtype=torch.int32, device=dev)
            with_err = mode == 2
            x_norm = torch.full((b,), x_norm_full.item(), device=dev)
            err_inputs = (x_norm, grams[0], grams[1]) if with_err else None
            flops = b * (4 * i * r * r + i * r + (12 * i * r + 20 * r * r if with_err else 0))
            nbytes = 4 * (2 * b * i * r + 2 * b * r * r + b * r + 2 * b) + (4 * (2 * b * r * r + 2 * b) if with_err else 0)
            row["apply"] = dict(
                **bound(flops, PEAK_FP32, nbytes),
                max_abs_err=max(errs), max_err_rel=max(err_errs), with_err=with_err,
                ms=cuda_ms(lambda: fe.epilogue_apply(g, hinv, iters, jk, False, err_inputs)),
                graph_ms=graph_ms(lambda: fe.epilogue_apply(g, hinv, iters, jk, False, err_inputs)),
                plain_ms=cuda_ms(lambda: fe.epilogue_apply_plain(g, hinv, iters, jk, False, err_inputs)),
                library_ms=None,
            )
            rows.append(row)
            print(f"kernels B={b:3d} R={r:2d} mode={mode}: mttkrp "
                  + " ".join(f"{t}={row['mttkrp'][t]['ms']:.4f}ms (graph {row['mttkrp'][t]['graph_ms']:.4f})"
                             for t in TIERS)
                  + f" twostep (highest) {row['mttkrp']['highest']['library_ms']:.4f}ms (graph "
                  f"{row['mttkrp']['highest']['library_graph_ms']:.4f})"
                  + f" hinv={row['hinv']['ms']:.4f}ms (graph {row['hinv']['graph_ms']:.4f}, "
                  f"{row['hinv']['path']} path, cond <= {row['hinv']['cond_max']:.3g}, "
                  f"err/(cond*max) {row['hinv']['ratio']:.3g}) apply={row['apply']['ms']:.4f}ms "
                  f"(graph {row['apply']['graph_ms']:.4f}, error {with_err})",
                  flush=True)
    return rows, worst


# ------------------------------------------------------------ engine phase


def engine_queue(rng):
    from cp_cals_tpu_torch import random_ktensor_host

    return [
        random_ktensor_host(rng, MODES, r, dtype=np.float32)
        for r in range(1, 21) for _ in range(20)
    ]


def wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from cp_cals_tpu_torch import probe_overhead as probe
    from cp_cals_tpu_torch.ops import fused_epilogue as fe
    from cp_cals_tpu_torch.ops import fused_mttkrp as fm
    from cp_cals_tpu_torch.ops import spd_inverse as si

    return {
        "fused_mttkrp_fp32": fm.fused_mttkrp_fp32,
        "fused_mttkrp_tc": fm.fused_mttkrp_tc,
        "normal_inverse": fe.normal_inverse,
        "epilogue_apply": fe.epilogue_apply,
        "spd_inverse": si.spd_inverse,
        "probe_copy": probe.probe_copy,
    }


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


MTTKRP_KERNEL = {"highest": "fused_mttkrp_fp32", "high": "fused_mttkrp_tc", "default": "fused_mttkrp_tc"}


def fused(tier: str) -> tuple:
    """The kernels one bucket-iteration of the fused-epilogue path launches
    per mode: the MTTKRP kernel of the MTTKRP's tier, then the epilogue."""
    return (MTTKRP_KERNEL[tier], "normal_inverse", "epilogue_apply")


def unfused(tier: str) -> tuple:
    """... of the unfused path through the SPD-inverse kernel."""
    return (MTTKRP_KERNEL[tier], "spd_inverse")


def check_launches(name: str, counts: dict, per_step: tuple, steps: int) -> None:
    """The kernels in ``per_step`` launched 3 x ``steps`` times (once per
    mode of each bucket-iteration), every other kernel not at all."""
    for k, v in counts.items():
        want = 3 * steps if k in per_step else 0
        if v != want or (k in per_step and v == 0):
            raise AssertionError(f"{name}: {k} launched {v} times, expected {want} (3 x {steps})")


def bench_params(**tiers):
    """The bench workload's engine settings at the given precision tiers."""
    from cp_cals_tpu_torch import CalsParams

    return CalsParams(
        max_iterations=ITERS, force_max_iter=True, bucket_ranks=BUCKETS,
        buffer_size=BUFFER, tail_compaction_depth=0, tol=1e-6, **tiers,
    )


def engine_run(x, queue, tiers: dict, name: str, check_fit: bool = True):
    from cp_cals_tpu_torch import cp_cals

    params = bench_params(**tiers)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results, rep = cp_cals(x, queue, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bucket_iters = sum(rep.engine_iterations.values())
    check_launches(name, counts, fused(params.mttkrp_precision or params.precision), bucket_iters)
    if len(results) != len(queue) or any(kt is None for kt in results):
        raise AssertionError(f"{name}: missing results")
    for kt, q in zip(results, queue):
        if tuple(f.shape for f in kt.factors) != tuple(f.shape for f in q.factors):
            raise AssertionError(f"{name}: result shapes differ from the queue's")
        if not all(np.isfinite(f).all() for f in kt.factors) or not np.isfinite(kt.lam).all():
            raise AssertionError(f"{name}: non-finite factors")
    fits = np.array([m.fit for m in rep.models])
    iters = np.array([m.iters for m in rep.models])
    if (not np.isfinite(fits).all() or fits.max() > 1.0 or (iters != ITERS).any()
            or (check_fit and fits.mean() < 0.5)):
        raise AssertionError(f"{name}: fits {fits.mean()} iters {set(iters.tolist())}")
    out = dict(
        wall_s=wall, models_per_s=len(queue) / wall, mean_fit=float(fits.mean()),
        mean_iters=float(iters.mean()), bucket_iterations=rep.engine_iterations,
        launches=counts, phase_times={str(k): v for k, v in rep.phase_times.items()},
    )
    print(f"engine {name}: wall {wall:.3f}s, {out['models_per_s']:.1f} models/s, "
          f"mean fit {out['mean_fit']:.6f}, mean iters {out['mean_iters']}, "
          f"bucket-iterations {bucket_iters}, launches {counts}", flush=True)
    return results, rep, out


def cross_check(x, queue, runs: dict) -> dict:
    """20 models (one per rank) of each engine run against the port's
    float64 CPU run from the same inits: the largest |fit difference| and
    relative reconstruction difference, held to CROSS_TOL per run."""
    from cp_cals_tpu_torch import Ktensor, cp_cals
    from cp_cals_tpu_torch.ktensor import to_tensor

    def dense(kt):
        return to_tensor(Ktensor(tuple(torch.from_numpy(f.astype(np.float64)) for f in kt.factors),
                                 torch.from_numpy(kt.lam.astype(np.float64))))

    pick = [20 * (r - 1) for r in range(1, 21)]
    q64 = [Ktensor(tuple(f.astype(np.float64) for f in queue[i].factors),
                   queue[i].lam.astype(np.float64)) for i in pick]
    res64, rep64 = cp_cals(x.astype(np.float64), q64, bench_params(), device="cpu")
    out = {}
    for name, (results, rep) in runs.items():
        worst_fit = worst_rec = 0.0
        for n, i in enumerate(pick):
            worst_fit = max(worst_fit, abs(rep.models[i].fit - rep64.models[n].fit))
            a, b = dense(results[i]), dense(res64[n])
            worst_rec = max(worst_rec, (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item())
        print(f"cross-check {name} vs CPU float64 (20 models): max |fit diff| {worst_fit:.3e}, "
              f"max relative reconstruction diff {worst_rec:.3e}", flush=True)
        fit_tol, rec_tol = CROSS_TOL[name]
        if not (worst_fit <= fit_tol and worst_rec <= rec_tol):
            raise AssertionError(f"cross-check of {name} against the CPU float64 run failed")
        out[name] = dict(max_fit_diff=worst_fit, max_rel_recon_diff=worst_rec)
    return out


# ------------------------------------------------------------ jackknife phase


def jk_params(**kw):
    """The JAX bench's jackknife configuration (bench.py, BASELINE config
    4): 299 replicates of a rank-5 model in one bucket of rank 8."""
    from cp_cals_tpu_torch import CalsParams

    base = dict(tol=1e-6, max_iterations=100, buffer_size=4200, bucket_ranks=(JK_BUCKET,),
                precision="high", dimtree="off", evict_batch=48, result_wire_dtype="float16")
    return CalsParams(**{**base, **kw})


def fit_jk_model(x_np):
    """The model the jackknife resamples: rank 5, fitted by cp_als on the
    card from a seeded init at the "highest" tier, through the fused kernels."""
    from cp_cals_tpu_torch import AlsParams, cp_als, random_ktensor_host

    kt0 = random_ktensor_host(np.random.default_rng(JK_SEED), MODES, JK_RANK)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kt, rep = cp_als(x_np, kt0, AlsParams(precision="highest", tol=1e-8, max_iterations=500))
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_launches("cp_als", counts, fused("highest"), rep.iters)
    if not (np.isfinite(rep.fit) and 0.5 < rep.fit <= 1.0):
        raise AssertionError(f"cp_als: fit {rep.fit}")
    out = dict(wall_s=wall, fit=rep.fit, iters=rep.iters, converged=rep.converged, launches=counts)
    print(f"cp_als rank {JK_RANK}: fit {rep.fit:.6f} in {rep.iters} iterations "
          f"(converged {rep.converged}), wall {wall:.3f}s, launches {counts}", flush=True)
    return kt, out


class SpdRecorder:
    """Observes the unfused solve's calls of ``spd_inverse`` during one run:
    how many launches took each (B, R), the first input of each shape, and
    the inputs of the bucket-iterations in HINV_SNAPSHOTS and of the last
    one (replicates start from the fitted model, so a run may end before
    iteration 10). The counts stay the wrapper's own; the inputs are kept by
    reference (nothing writes to them)."""

    def __enter__(self):
        from cp_cals_tpu_torch.ops import update

        self.module, self.real = update, update.spd_inverse
        self.shapes, self.first, self.snap_inputs, self.last, self.n = {}, {}, [], {}, 0

        def record(h):
            it, mode = self.n // 3 + 1, self.n % 3
            self.n += 1
            shape = tuple(h.shape[:2])
            self.shapes[shape] = self.shapes.get(shape, 0) + 1
            self.first.setdefault(shape, h)
            if it in HINV_SNAPSHOTS:
                self.snap_inputs.append((it, mode, h))
            self.last[mode] = (it, mode, h)
            return self.real(h)

        update.spd_inverse = record
        return self

    def __exit__(self, *exc):
        self.module.spd_inverse = self.real

    @property
    def snaps(self) -> list:
        """(bucket-iteration, mode, H) at the snapshots and the last
        bucket-iteration."""
        return self.snap_inputs + [e for e in self.last.values() if e[0] not in HINV_SNAPSHOTS]


def jk_run(name: str, run, per_step: tuple) -> tuple:
    """One jackknife run from counts at 0: launches, 299 well-formed
    replicates (factor 0 NaN exactly on its fiber's row, finite elsewhere,
    finite lam), wall and replicates/s."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bucket_iters = sum(rep.cals_report.engine_iterations.values())
    check_launches(name, counts, per_step, bucket_iters)
    (reps,) = rep.results
    if len(reps) != MODES[0]:
        raise AssertionError(f"{name}: {len(reps)} replicates")
    rows = np.arange(MODES[0])
    for fiber, kt in enumerate(reps):
        f0 = kt.factors[0]
        nan_rows = np.isnan(f0).any(axis=1)
        if (not np.array_equal(nan_rows, rows == fiber) or not np.isnan(f0[fiber]).all()
                or not all(np.isfinite(f).all() for f in kt.factors[1:]) or not np.isfinite(kt.lam).all()):
            raise AssertionError(f"{name}: replicate {fiber} is malformed")
    iters = np.array([m.iters for m in rep.cals_report.models])
    out = dict(wall_s=wall, replicates_per_s=len(reps) / wall, mean_iters=float(iters.mean()),
               bucket_iterations=rep.cals_report.engine_iterations, launches=counts)
    print(f"jackknife {name}: wall {wall:.3f}s, {out['replicates_per_s']:.1f} replicates/s, "
          f"mean iters {out['mean_iters']:.2f}, bucket-iterations {bucket_iters}, launches {counts}",
          flush=True)
    return rep, out


class MttkrpRecorder:
    """Observes the MTTKRP calls of one run through the tier dispatcher
    ``fused_mttkrp`` (the kernel wrappers' counts stay their own): how many
    launches took each (B, target mode, tier), and the first inputs of each,
    kept by reference (nothing writes to them)."""

    def __enter__(self):
        from cp_cals_tpu_torch.ops import fused_mttkrp as fm

        self.module, self.real = fm, fm.fused_mttkrp
        self.shapes, self.first = {}, {}

        def record(x3, u1, u2, precision="highest"):
            key = (u1.shape[0], MODES.index(x3.shape[-2]), precision)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            self.first.setdefault(key, (x3, u1, u2))
            return self.real(x3, u1, u2, precision)

        fm.fused_mttkrp = record
        return self

    def __exit__(self, *exc):
        self.module.fused_mttkrp = self.real


def mttkrp_mix(rec, x) -> list:
    """The MTTKRP kernel at every (B, mode, tier) of a recorded run, on that
    run's own inputs: held against its plain version at TOL["mttkrp"] and
    timed, with the torch twostep at the same tier beside it."""
    from cp_cals_tpu_torch.ops import fused_mttkrp as fm

    mix = []
    for (b, mode, tier), n in sorted(rec.shapes.items(), reverse=True):
        x3, u1, u2 = rec.first[(b, mode, tier)]
        got, want = fm.fused_mttkrp(x3, u1, u2, tier), fm.fused_mttkrp_plain(x3, u1, u2, tier)
        torch.cuda.synchronize()
        err, scale = rel_err(got, want)
        if not err <= TOL["mttkrp"] * scale:
            raise AssertionError(f"fused_mttkrp {tier} B={b} mode={mode} (recorded inputs): {err} vs {scale}")
        small, big = fm.split_others(MODES, mode)
        j, i, k, r = MODES[small], MODES[mode], MODES[big], u1.shape[2]
        x_ts = x.permute(mode, small, big).reshape(-1, k)
        flops = (2 * j * i * k * b * r + 2 * j * i * b * r) * (3 if tier == "high" else 1)
        mix.append(dict(
            B=b, R=r, mode=mode, tier=tier, launches=n, max_abs_err=err, ref_max=scale,
            **bound(flops, PEAK_FP32 if tier == "highest" else PEAK_BF16, x3.nbytes + 4 * b * (j + k + i) * r),
            ms=cuda_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
            graph_ms=graph_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
            plain_ms=cuda_ms(lambda: fm.fused_mttkrp_plain(x3, u1, u2, tier)),
            library_ms=cuda_ms(lambda: twostep(x_ts, u1, u2, tier)),
        ))
        m = mix[-1]
        print(f"mttkrp J1 mix {tier} B={b} R={r} mode={mode} ({n} launches): {m['ms']:.4f}ms "
              f"(graph {m['graph_ms']:.4f}), plain {m['plain_ms']:.4f}ms, twostep {m['library_ms']:.4f}ms, "
              f"bound {m['bound_ms']:.4f}ms, err/max {err / scale:.2e}", flush=True)
    return mix


def jk_phase(x_np, kt5):
    from cp_cals_tpu_torch import AlsParams, jk_cp_batched_als, jk_cp_cals

    shared = dict(tol=1e-6, max_iterations=100, precision="high", dimtree="off")
    runs = {}
    with MttkrpRecorder() as j1_rec:
        _, runs["J1"] = jk_run("J1", lambda: jk_cp_cals(x_np, [kt5], jk_params()), fused("high"))
    with SpdRecorder() as rec:
        _, runs["J2"] = jk_run("J2", lambda: jk_cp_cals(x_np, [kt5], jk_params(solve_method="pallas")),
                               unfused("high"))
    _, runs["J3"] = jk_run(
        "J3", lambda: jk_cp_batched_als(x_np, [kt5], AlsParams(**shared, solve_method="pallas")), unfused("high"))
    return runs, rec, j1_rec


def replicate_diff(got, want, fiber: int) -> tuple[float, float]:
    """(relative reconstruction difference with the NaN row dropped,
    largest |lam difference| over the largest |lam|) of two replicates."""
    def dense(kt):
        f0 = np.delete(kt.factors[0].astype(np.float64), fiber, axis=0)
        fs = [f0] + [f.astype(np.float64) for f in kt.factors[1:]]
        return np.einsum("ir,jr,kr,r->ijk", *fs, kt.lam.astype(np.float64))

    a, b = dense(got), dense(want)
    rec = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    lam = float(np.abs(got.lam - want.lam).max() / np.abs(want.lam).max())
    return rec, lam


def jk_cross_check(x_np, kt5) -> dict:
    """J1 and J2 again at 10 forced iterations against the port's float64
    CPU run of 10 fibers from the same model, both rescaled and
    LSAP-adjusted: held to JK_CROSS_TOL."""
    from cp_cals_tpu_torch import Ktensor, cp_cals, jk_cp_cals
    from cp_cals_tpu_torch.solvers.jackknife import (
        _rescale_replicate,
        jk_permutation_adjustment,
        to_host_model,
    )

    ref = to_host_model(Ktensor(tuple(f.astype(np.float64) for f in kt5.factors), kt5.lam.astype(np.float64)))
    fibers = [int(f) for f in np.linspace(0, MODES[0] - 1, 10).round()]
    p64 = jk_params(force_max_iter=True, max_iterations=10, precision="highest", result_wire_dtype=None)
    res64, _ = cp_cals(x_np.astype(np.float64), [ref] * len(fibers), p64, jk_fibers=fibers, device="cpu")
    want = jk_permutation_adjustment(ref, [_rescale_replicate(k, f) for k, f in zip(res64, fibers)])
    out = {}
    for name, solve in (("J1", "gj"), ("J2", "pallas")):
        rep = jk_cp_cals(x_np, [kt5], jk_params(force_max_iter=True, max_iterations=10, solve_method=solve))
        diffs = [replicate_diff(rep.results[0][f], w, f) for f, w in zip(fibers, want)]
        rec, lam = max(d[0] for d in diffs), max(d[1] for d in diffs)
        print(f"cross-check {name} (10 forced iterations, 10 fibers) vs CPU float64: max relative "
              f"reconstruction diff {rec:.3e}, max relative |lam| diff {lam:.3e}", flush=True)
        rec_tol, lam_tol = JK_CROSS_TOL
        if not (rec <= rec_tol and lam <= lam_tol):
            raise AssertionError(f"jackknife cross-check of {name} against the CPU float64 run failed")
        out[name] = dict(max_rel_recon_diff=rec, max_rel_lam_diff=lam)
    return out


def spd_phase(rec, dev) -> dict:
    """The SPD-inverse kernel against its plain version on the card: on the
    normal matrices J2 inverted at SNAPSHOTS, and on random SPD batches at
    R = 4, 20, 32, 33, 64 (both paths of csrc/gj_elim.cuh and their
    boundary) with condition numbers up to about 1e4 and dead identity
    slots. Times at every (B, R) of J2's launch mix."""
    from cp_cals_tpu_torch.ops import spd_inverse as si

    gen = np.random.default_rng(13)
    cases = [(f"J2 iteration {it} mode {mode}", h) for it, mode, h in rec.snaps]
    for r in (4, 20, 32, 33, 64):
        q, _ = np.linalg.qr(gen.normal(size=(320, r, r)))
        top = np.geomspace(1.0, 1e4, 320)[:, None]
        h = np.einsum("bij,bj,bkj->bik", q, top ** np.linspace(0.0, 1.0, r)[None, :], q)
        h[::7] = np.eye(r)  # dead slots
        cases.append((f"random R={r}", torch.from_numpy(h.astype(np.float32)).to(dev)))
    its = sorted({it for it, _, _ in rec.snaps})
    if its[0] != 1 or len(rec.snaps) != 3 * len(its):
        raise AssertionError(f"spd_inverse: J2 snapshots at iterations {its}, {len(rec.snaps)} inputs")
    checks, worst = [], 0.0
    for label, h in cases:
        got, want = si.spd_inverse(h), si.spd_inverse_plain(h)
        torch.cuda.synchronize()
        reading = hinv_reading(got, want, h)
        if not reading["ratio"] <= TOL["hinv"]:
            raise AssertionError(f"spd_inverse {label}: {reading}")
        eye = torch.eye(h.shape[-1], device=dev).expand_as(h)
        if hinv_reading(2 * eye - h, want, h)["ratio"] <= TOL["hinv"]:
            raise AssertionError(f"spd_inverse {label}: 2I - H passes the check")
        dead = (h == eye).all(dim=(1, 2))
        if not torch.equal(got[dead], eye[dead]):
            raise AssertionError(f"spd_inverse {label}: a dead slot is not the identity")
        checks.append(dict(case=label, B=h.shape[0], R=h.shape[-1], path=inverse_path(*h.shape[:2]), **reading))
        worst = max(worst, reading["max_abs_err"])
    mix = []
    for (b, r), n in sorted(rec.shapes.items()):
        h = rec.first[(b, r)]
        flops = b * r * (1 + 2 * r + 4 * r * (r - 1))
        mix.append(dict(B=b, R=r, launches=n, path=inverse_path(b, r), **bound(flops, PEAK_FP32, 2 * 4 * b * r * r),
                        ms=cuda_ms(lambda: si.spd_inverse(h)),
                        graph_ms=graph_ms(lambda: si.spd_inverse(h)),
                        plain_ms=cuda_ms(lambda: si.spd_inverse_plain(h)),
                        library_ms=cuda_ms(lambda: torch.linalg.inv(h))))
    for c in checks:
        print(f"spd_inverse {c['case']}: B={c['B']} R={c['R']} ({c['path']} path) cond <= {c['cond_max']:.3g}, "
              f"err/(cond*max) {c['ratio']:.3g}", flush=True)
    for m in mix:
        print(f"spd_inverse B={m['B']} R={m['R']} ({m['launches']} launches in J2, {m['path']} path): {m['ms']:.4f}ms "
              f"(graph {m['graph_ms']:.4f}), "
              f"plain {m['plain_ms']:.4f}ms, torch.linalg.inv {m['library_ms']:.4f}ms, "
              f"bound {m['bound_ms']:.2e}ms", flush=True)
    return dict(checks=checks, mix=mix, max_abs_err=worst)


# ------------------------------------------------------------ probe phase


def probe_phase(dev) -> dict:
    """The launch-overhead probe from counts at 0, then its copy kernel held
    to exact equality with x * 0.999 and timed at both shapes."""
    from cp_cals_tpu_torch import probe_overhead as probe

    torch.cuda.synchronize()
    reset_counts()
    res = probe.run_probe()
    counts = read_counts()
    for k, v in counts.items():
        if (v == 0) == (k == "probe_copy"):
            raise AssertionError(f"probe: {k} launched {v} times")
    probe.report(res)
    gen = torch.Generator().manual_seed(3)
    shapes = []
    for shape in (probe.SMALL, probe.BIG):
        x = torch.randn(shape, generator=gen).to(dev)
        if not torch.equal(probe.probe_copy(x), probe.probe_copy_plain(x)):
            raise AssertionError(f"probe_copy {shape}: not bit-identical to x * 0.999")
        n = x.numel()
        shapes.append(dict(shape=shape, **bound(n, PEAK_FP32, 8 * n),
                           ms=cuda_ms(lambda: probe.probe_copy(x)),
                           graph_ms=graph_ms(lambda: probe.probe_copy(x)),
                           plain_ms=cuda_ms(lambda: probe.probe_copy_plain(x)),
                           library_ms=cuda_ms(lambda: torch.mul(x, 0.999))))
        print(f"probe_copy {shape}: exact; {shapes[-1]['ms']:.4f}ms (graph {shapes[-1]['graph_ms']:.4f}), "
              f"plain {shapes[-1]['plain_ms']:.4f}ms, torch.mul {shapes[-1]['library_ms']:.4f}ms", flush=True)
    return dict(result=res, launches=counts["probe_copy"], shapes=shapes)


def weighted(rows, bucket_iters, key, field, tier=None):
    num = den = 0.0
    for row in rows:
        w = bucket_iters.get(row["R"], 0)
        entry = row[key][tier] if tier else row[key]
        num += w * entry[field]
        den += w
    return num / den


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from cp_cals_tpu_torch import _build

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load("fused_mttkrp.cu")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f}s (nvcc wall {_build.BUILD_SECONDS.get('wall')})", flush=True)

    x_np, rng = bench_tensor()
    x = torch.from_numpy(x_np).to(dev)
    rows, worst = kernel_phase(x, dev)

    queue = engine_queue(rng)
    engine_run(x_np, queue[::80], {}, "warm-up", check_fit=False)
    res_a, rep_a, run_a = engine_run(x_np, queue, {}, "highest")
    res_b, rep_b, run_b = engine_run(x_np, queue, BENCH_TIERS, "bench-tiers")
    check = cross_check(x_np, queue, {"highest": (res_a, rep_a), "bench-tiers": (res_b, rep_b)})

    kt5, fit5 = fit_jk_model(x_np)
    jk_runs, rec, j1_rec = jk_phase(x_np, kt5)
    j1_mix = mttkrp_mix(j1_rec, x)
    spd = spd_phase(rec, dev)
    jk_check = jk_cross_check(x_np, kt5)
    probe = probe_phase(dev)

    # Each kernel at the launch mix of the engine run that drives it: the
    # fp32 MTTKRP at "highest", everything else at the bench tiers.
    spec = [
        ("fused_mttkrp_fp32", "mttkrp", "highest", run_a, rep_a, "cp_cals_tpu_torch/csrc/fused_mttkrp.cu",
         "cp_cals_tpu/ops/pallas_mttkrp.py:98"),
        ("fused_mttkrp_tc", "mttkrp", BENCH_TIERS["mttkrp_precision"], run_b, rep_b,
         "cp_cals_tpu_torch/csrc/fused_mttkrp_tc.cu", "cp_cals_tpu/ops/pallas_mttkrp.py:98"),
        ("normal_inverse", "hinv", None, run_b, rep_b, "cp_cals_tpu_torch/csrc/fused_epilogue.cu",
         "cp_cals_tpu/ops/pallas_epilogue.py:63"),
        ("epilogue_apply", "apply", None, run_b, rep_b, "cp_cals_tpu_torch/csrc/fused_epilogue.cu",
         "cp_cals_tpu/ops/pallas_epilogue.py:186"),
    ]
    kernels = []
    for name, key, t, run, rep, source, replaces in spec:
        w = rep.engine_iterations

        def mean(field, t=t, key=key, w=w):
            return weighted(rows, w, key, field, t)

        err = (max(row[key][t]["max_abs_err"] for row in rows) if key == "mttkrp" else worst[key])
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=run["launches"][name], max_abs_err=err,
            ms=mean("ms"), graph_ms=mean("graph_ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by="operations" if mean("bound_ops_ms") >= mean("bound_bytes_ms") else "bytes",
            library_ms=None if key == "apply" else mean("library_ms"),
        )
        if key == "mttkrp":
            entry["tier"] = t
        if name == "fused_mttkrp_fp32":
            entry["library_graph_ms"] = mean("library_graph_ms")
            print(f"fused_mttkrp_fp32 at the highest engine's mix: {entry['ms']:.4f}ms eager, "
                  f"{entry['graph_ms']:.4f}ms graph-replayed; torch twostep {entry['library_ms']:.4f}ms eager, "
                  f"{entry['library_graph_ms']:.4f}ms graph-replayed; bound {entry['bound_ms']:.4f}ms", flush=True)
        if name == "epilogue_apply":
            entry["max_err_rel"] = worst["apply_err"]
        if name == "fused_mttkrp_tc":
            entry["max_abs_err"] = max(err, max(m["max_abs_err"] for m in j1_mix))
            entry["by_tier"] = {tt: {f: mean(f, tt) for f in ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms")}
                                for tt in ("default", "high")}
            n = sum(m["launches"] for m in j1_mix)
            entry["j1_mix"] = dict(launches=n, **{
                f: sum(m["launches"] * m[f] for m in j1_mix) / n
                for f in ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms")})
        kernels.append(entry)
    for name, mix, source, replaces, launches, err in (
        ("spd_inverse", spd["mix"], "cp_cals_tpu_torch/csrc/spd_inverse.cu",
         "cp_cals_tpu/ops/pallas_solve.py:37", jk_runs["J2"]["launches"]["spd_inverse"], spd["max_abs_err"]),
        ("probe_copy", probe["shapes"], "cp_cals_tpu_torch/csrc/probe_copy.cu",
         "scripts/probe_overhead.py:91", probe["launches"], 0.0),
    ):
        def mean(field, mix=mix):
            # J2's launch mix for the SPD inverse; the probe launches both shapes equally.
            n = [m.get("launches", 1) for m in mix]
            return sum(k * m[field] for k, m in zip(n, mix)) / sum(n)

        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches,
            max_abs_err=err, ms=mean("ms"), graph_ms=mean("graph_ms"), plain_ms=mean("plain_ms"),
            bound_ms=mean("bound_ms"),
            bound_by="operations" if mean("bound_ops_ms") >= mean("bound_bytes_ms") else "bytes",
            library_ms=mean("library_ms"),
        ))

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, shapes=rows, engine={"highest": run_a, "bench_tiers": run_b},
                       cross_check=check, cp_als=fit5, jackknife=jk_runs, jk_cross_check=jk_check,
                       mttkrp_j1_mix=j1_mix,
                       spd_inverse=spd, probe=probe, kernels=kernels), fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
