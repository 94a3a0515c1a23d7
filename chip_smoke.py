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
   timed with CUDA events, and the port's twostep and krp_gemm beside them. The MTTKRP runs at every tier on that tier's held
   layout of X: "highest" through the fp32 kernel, "high" and "default"
   through the tensor-core kernel. The normal inverse is held on the engine's own
   normal matrices: a bucket of bench-workload models run through the
   port's iteration on the card. The apply is held on every mode with and
   without the FastALS error it finishes on the last mode, and timed as
   the iteration calls it (the error on mode 2). The fp32 MTTKRP is also
   timed against the torch twostep replayed from a CUDA graph.
3b. Table: utils/lut.autotune on the card into a scratch root (the
   committed tables stay as they are) at every (B, R) the engine allocates
   for the bench workload, at "highest" and "default", and on the 4-D bench
   tensor at "default": each mode's winner beside each candidate's
   replayed ms per call, the committed table's pick and the fixed rule's.
   From here on the main path's runs (the bench workload's engine runs,
   the 4-D runs, the NNLS run, the entry points) resolve mttkrp_method=AUTO
   per bucket and tier from the committed tables
   (cp_cals_tpu_torch/lookup_tables/, measured by tools/lut_tables.py):
   no decision may fall to the heuristic, and each run's launches and
   MTTKRP results by route must equal its buckets' picks
   (lut.lookup_methods at the engine's (R, B)); their CPU references run
   each bucket with the card's picks. The phases that test a kernel's
   launches (warm-ups, the dimension tree, the line searches, the float64
   problem, the jackknife, the debug run, the NNLS side runs) pin
   mttkrp_method=PALLAS.
4. Engine: cp_cals on the full bench workload (400 models, ranks 1-20 x 20,
   buckets 4/8/12/16/20, 10 forced iterations) through the kernels and the
   device-paced loop (CUDA-graph replays), at the "highest" tier and then
   at the bench tiers (precision="high", mttkrp_precision="default"); the
   bench-tier run again with sync_mode="iter" (the eager per-iteration
   loop), whose every model's fit, iteration count and factors must equal
   the graph loop's bit for bit. Then the headline leg of bench.py: 50
   forced iterations, polish_iters=1, float16 wire, at the bench tiers.
   Each run starts with every launch count at 0; under AUTO its launches
   and routes must be its buckets' picks (3b), and a run with a pinned
   method's kernels (the MTTKRP kernel of its tier) must have launched 3 x
   (the bucket-iterations the engine ran + its polish sweeps), replays
   included, every other kernel not at all, and the MTTKRP results by
   route (``launches.routes``) as the run's path says. In the graph-loop
   runs 20 models (one of each rank) are cross-checked against the port's
   own float64 run on the CPU from the same inits. Then the other routes on
   the bench tensor: explicit twostep and krp_gemm at "highest" (no MTTKRP
   kernel), the bench-tier run with mode_layouts="recompute" (bit for bit
   the held layouts' run), and dimtree="on" at "highest" (the fused kernel
   on mode 0, modes 1 and 2 from one shared TTM), timed in turns with "off"
   (off, on, on, off); the three cross-checked like "highest". A small
   float64 problem on the card: the gates send it to the twostep and the
   unfused path (no kernel launches), against the same run on the CPU.
   Every engine run of the script runs its buckets in one thread, the
   engine's default (4 threads ran the bench workload slower on the card,
   PERF.md); phase 4a and the cuda tests hold 4 threads to it.
4a. Bucket threads: the bench workload at the bench tiers and at
   "highest", bucket_threads=1 and 4 in turns (1, 4, 4, 1, 1, 4): every
   threaded run bit for bit the first serial run, with equal launches,
   routes, and captures, replays and stats fetches per bucket; each run's
   wall and phase times printed, and one profiled run of
   each thread count (tools/profile_engine.py's profile_run): the device's
   busy share, the host's time in launch calls and in synchronising calls.
4b. N-D: the bench workload with a fourth mode of 8 (299x301x41x8, 29.5 M
   entries; the same 400 models, buckets and budget; 10 forced
   iterations) at "highest" and at the bench tiers. Every mode takes the
   table's pick, the twostep or krp_gemm (four route counts per
   bucket-iteration, no MTTKRP kernel), every normal inverse multiplies
   K = 3 gramians and one apply per
   bucket-iteration finishes the K = 3 error (both recorded by K, replays
   included). One model per bucket is cross-checked against the port's
   float64 CPU run (with the float32 CPU run's distance beside it); the
   bench-tier run is traced with torch.profiler for the device's busy
   share and time by kernel, and each bucket's picked MTTKRP is timed at
   every (B, mode) of it for its share of that time. Then the widened epilogue kernels at
   K = 3 and 4 (a fifth mode of 5) against their plain versions at every
   (B, R) of the engine and every mode, timed (K = 2 is phase 3's).
4c. NNLS at full width (the JAX package's NNLS experiment,
   cp_cals_tpu/experiments.py:442-483, without --quick): the absolute
   values of a seeded rank-5 Ktensor as a 100x100x100 float32 target
   (NumPy's draw: JAX's threefry keys are not reproduced), 100 models of
   ranks 1-10 x 10, buckets 4/8/12, 50 forced iterations at "high", block
   principal pivoting, through the graph loop: only the tensor-core MTTKRP
   launches (three per bucket-iteration; the epilogue kernels none), every
   factor entry >= 0 exactly. The run's MTTKRP calls are recorded, replays
   included, and the tensor-core kernel is held against its plain version
   and timed on the run's own inputs at each (B, R, mode) of its launch
   mix. CALS against each model's ALS on the card (cp_batched_als per
   rank) by fit, the models furthest apart again in float64 and in float32
   on the CPU, and 10 fits against the port's float64 CPU run;
   Lawson-Hanson and BPP on the rank-8 bucket on the card, each against
   the port's float64 CPU run of that bucket (where the two algorithms
   agree), with both walls; the NNLS update's device time per
   bucket-iteration at each bucket, both algorithms, eager and replayed.
4d. Line search at full width: the bench workload at "highest", 20 forced
   iterations, interval 5, NO_ERROR_CHECKING and ERROR_CHECKING, each in
   the graph loop and in sync_mode="iter" (bit for bit), ERROR_CHECKING's
   candidate MTTKRP predicated once per bucket-iteration, 20 models
   against the port's float64 CPU run.
5. Jackknife, at full width (the JAX bench's jackknife configuration): a
   rank-5 model of the bench tensor fitted by cp_als on the card, then its
   299 leave-one-out replicates in one bucket of rank 8 (B = 320), each
   through the graph loop: J1 jk_cp_cals as pinned (fused epilogue); J2
   the same with solve_method="pallas" (unfused epilogue through the
   SPD-inverse kernel); J3 jk_cp_batched_als with solve_method="pallas"
   (one bucket of rank 5); J4 the bench's --fast tier (mttkrp_precision=
   "default", tol_check_interval=5, polish_iters=25, polish_tol=1e-6). Each
   run starts with every count at 0 and must launch exactly its path's
   kernels 3 x (its bucket-iterations + polish sweeps); J4's predicated
   check MTTKRP is counted apart, once per bucket-iteration. Each returns
   299 replicates with factor 0 NaN on exactly its fiber's row. J1's
   MTTKRP calls and J2's SPD inverses are recorded in those runs, replays
   included (a recorder's tallies advance with each graph replay, as the
   launch counts do, and must sum to them), and the tensor-core kernel is
   held against its plain version and timed on J1's own inputs at each
   (B, mode) of J1's launch mix. J1, J2 and J4 are run again at 10 forced
   iterations, and J4 once more as the bench runs it (tol-driven, polished)
   with float32 results, and 10 fibers are cross-checked against the
   port's float64 CPU run of the same settings (J4's stops within one
   check window).
5b. J1 with NEC line search (tol-driven), then at 10 forced iterations
   against the port's float64 CPU run of 10 fibers; a debug=True run
   (eager, no graph) with an injected rise of the error at each model's
   6th iteration, its recorded entries against the same run on the CPU.
5c. Multi-device (cp_cals_tpu_torch/parallel/): two ranks spawned on
   cuda:0, joined over gloo (backend="gloo", asked for: NCCL refuses two
   ranks on one card), each launching every kernel itself: (a) the
   bench-tier run (the bench workload at full width, 10 forced iterations,
   the fused kernels pinned) under dp = 2, each rank on its half of every
   bucket's slots, chunks captured; (b) the same under tp = 2, each rank on
   its 150 or 149 rows of mode 0, the tp sums inside the iteration, mode
   0's MTTKRP gathered whole for the apply kernel (as GSPMD gathers the
   sharded operand around the Pallas apply), uncaptured; (c) J1 at 10
   forced iterations (299 replicates) under dp = 2; and the "highest" run
   (the fp32 kernel) under dp = 2 and under tp = 2, which hold the
   collectives to CROSS_TOL["highest"], where a wrong sum would show (the
   bf16 tiers amplify a rank's other rounding). Each rank's results are
   held against the single-process run of the same configuration (the
   bench-tier and "highest" runs, and J1 at 10 forced iterations run
   here; ``mesh_diff``, which tools/mesh_cards.py shares): equal
   iteration counts per model, bucket-iterations and stats fetches per
   bucket (the same chunks and eviction rounds), and the results within
   the cross-check tolerances (CROSS_TOL of the run's tiers,
   JK_CROSS_TOL). Each rank's launches per kernel are exact: 3 MTTKRPs,
   3 inverses and 3 applies per bucket-iteration. Printed: each rank's
   launches, its collectives (in the iteration, "tp", and in the host
   loop, "host") and their host seconds per bucket-iteration, the walls
   beside the single-process walls. Two ranks on one card show correctness and the
   cost of the collectives, not a speed-up.
6. SPD inverse: the kernel against its plain version on the normal
   matrices J2 inverted (each eager call's, and each captured call's
   last replay), and on random SPD batches (R = 4, 20, 32, 33, 64,
   cond up to 1e4, dead identity slots), timed at J2's launch mix. Both
   inverses record which path of their shared elimination (warp or block)
   each shape took.
6b. Entry points (the user's API and CLI), at full width: the README's
   command through cli.main (-t 299-301-41 -c 1:20:20 --compare-als --jk:
   400 models at "highest", batched ALS per rank, then the 20 best models'
   5,980 jackknife replicates), its output lines, its CSV's 400 rows, and
   the fp32 MTTKRP, normal inverse and apply launched; the same target
   written with tensor_io.write_tensor, read back equal, and run with
   --tensor-file --fast --wire float16 (the tensor-core MTTKRP launched).
   Both CLI runs record their MTTKRP, normal-inverse and apply calls
   (replays included; the recorded launches must sum to the counts), and
   each kernel is held against its plain version and timed on the run's
   own inputs at every (B, R, mode) it ran at (the launch mixes in the
   kernels line: "readme_cli_mix", "fast_cli_mix"); the README command's
   best model of each rank is held against the port's float64 CPU run
   from its init (CLI_CROSS_TOL). api.cp_cals at its defaults (tol-driven,
   evict_batch 1) with init="random" against the same call on the host-
   built queue, in turns: walls, setup and eviction-round times, spec
   builds, results bit for bit.
   api.cp_cals(init="random") on the bench tensor (ranks 1-20 x 20,
   buckets 4/8/12/16/20, buffer 2880, 10 forced iterations): its models
   are born on the card from their seeds and must equal the same run on
   the spec_to_ktensor queue built on the host bit for bit (both runs'
   bucket setup times printed). The same forced run cut after one
   eviction round per bucket with checkpoint_dir and resumed must equal
   the uninterrupted run bit for bit (seconds per snapshot, bytes on
   disk); traced, its records number its engine iterations, its stats
   fetches are the untraced run's, its results the same bits (walls of
   three runs each, in turns U T T U U T).
6c. Experiments (cp_cals_tpu_torch/experiments.py, the paper's harness):
   experiments.main at --quick with every leg (the ALS-vs-CALS grid at
   50^3, the NNLS comparison, the jackknife and jackknife-scale runs, the
   scale sweep, a jackknife of a tensor file written here with tensor_io,
   the defrag study), then at full width the base grid (compare_als_cals
   at 200^3, ranks 1-20 x 20, 50 forced iterations, buckets 4/8/12/16/20,
   "highest") and the scale sweep at the paper's 500^3 float32 cut in
   depth (25 copies a rank, 500 models, 10 forced iterations; "high",
   layouts derived in the loop). Every engine run of the harness is checked
   against the committed tables' picks (launches and routes), with no
   heuristic decision and no autotune; every comparison has no model
   beyond the 1e-1 check; every number is finite. Printed: the measured
   matmul peaks beside the data sheet's, the 500^3 sweep's MTTKRP TFLOP/s
   and its tensor-core share at "high", its peak allocated bytes.
6d. Stress (the JAX package's slow lane, tests/test_stress_oracle.py, at
   full size; stress_phase). S1: 360 models of ranks 1-12 (30 each,
   shuffled) on an exact rank-10 13x12x11 target, float64, tol 1e-5,
   through a 30-column buffer (buckets 2/4/8/12: continuous eviction,
   refill and tail compaction through the graph loop): cp_cals against
   cp_als on every third model (queue indices 0, 3, ..., 357, cut by index
   for the phase's time: STRESS_ALS_EVERY) and cp_batched_als on every
   same-rank group,
   equal iteration counts and reconstructions within 1e-11; no kernel
   takes float64, so none may launch. Printed: eviction rounds, refills,
   compactions, bucket-iterations, graph captures (and their seconds),
   replays, each path's wall. S2: the same models and buffer in float32 at
   "highest" with 30 forced iterations, each of the three paths launching
   exactly the fp32 MTTKRP, normal inverse and apply 3 x its iterations,
   against the float64 cp_cals run of those settings on the card and
   against each other (STRESS_CROSS_TOL). S3: the reference-scale
   jackknife (4 fitted rank-5 models of a 10x21x20 target, 40 replicates
   through an 18-column buffer): jk_cp_cals, jk_cp_als and
   jk_cp_batched_als in float64 within 1e-11 of each other, each replicate
   compared through jk_to_regular; jk_cp_cals in float32 at "highest" (the
   apply kernel zeroes the left-out row) against the float64 one
   (JK_STRESS_CROSS_TOL).
6e. Studies (the fidelity studies, cp_cals_tpu_torch/studies/, at full
   width, 299x301x41; studies_phase). The port's float64 oracles on the
   card (no kernel takes float64, so none may launch), each held to the
   JAX package's committed float64 oracle of the same study:
   convergence_run (6 models) and bench_tol (400 models) with equal
   iteration counts and fits within 1e-9, jk_fidelity_study's SE bands
   (299 replicates) within 1e-6 at the p99 of |dse| / se64 per mode. Then the float32 runs through the kernels,
   each launching exactly its path's kernels (3 x (bucket-iterations +
   polish sweeps), the mixed-tier check's MTTKRP once per bucket-iteration
   as a predicated launch): convergence_run at "highest", at a "default"
   MTTKRP with a plain stop (printed only) and with tol_check_interval=5
   and polish 2; jk_fidelity_study's f32_high, f32_high_xla and
   f32_default_polish_conv on all 299 replicates, compare's table printed;
   bench_tol's card leg at the script's defaults; bench_external_cpd's
   card row. Each float32 reading against the committed oracle, held to
   STUDY_BOUNDS (tools/study_bounds.py).
6f. Profiles (the component profiles and kernel A/Bs,
   cp_cals_tpu_torch/profiles/, at the JAX scripts' widths: 299x301x41,
   B = 96, R = 20, and update_variants' four (B, R) cases;
   profiles_phase): the full iteration chained on its state, the MTTKRP by
   krp_gemm and by the twostep per mode at every tier, the update's
   components and the matmul probes (profile_iteration); the ablation's
   four stages; the iteration with epilogue "xla" against "fused", the
   normal inverse and the apply with and without the error against their
   unfused counterparts (profile_epilogue_ab); the update by Cholesky,
   Gauss-Jordan and the SPD-inverse kernel and both normalize + gramian
   tails (profile_update_variants); the twostep against the fused MTTKRP
   per mode in turns (bench_pallas_ab); the fused MTTKRP's plans swept per
   mode at every tier against the twostep (tune_pallas_mttkrp). Each body
   is chained steps replayed from a CUDA graph and timed with CUDA events.
   Before it is timed each kernel is held against its plain version on the
   same inputs: the MTTKRP at the iteration's layouts, per mode of the A/B
   and at every swept plan of the three tiers, the normal inverse and the
   apply with and without the error, the SPD inverse at the four cases,
   and the iteration's state after one step fused against unfused. Each
   run launches exactly its kernels (replays counted); the JSONs go to
   chiprun_out/profiles/.
6g. The last scripts (scripts_phase; the JSONs and figures go to
   chiprun_out/scripts_phase/). The external MTTKRP study
   (studies/bench_mttkrp_external.py) at 299x301x41, ranks 5 and 20, one
   timed rep: every float64 contender (the port's krp_gemm and twostep on
   the card; torch, NumPy and the OpenMP C++ MTTKRP on the host) within
   1e-10 of the NumPy oracle, and the float32 rows of both fused kernels at
   B = 1 ("highest" and "default"), each held to its plain version at 2e-5
   of max|G| and launched exactly twice (warm-up and rep) per (mode, rank)
   the gate takes, no other kernel. The grid tuner
   (profiles/tune_lut_grid.py) at the bench workload's queue (buckets
   4/8/12/16/20, buffer 2880, the halving ladder) at "default" into an
   empty scratch root under build/: no exact lookup before, all exact
   after, every pick one the gate takes. The layout-policy A/B
   (tools/layout_policy_ab.py) at the 500^3 sweep's cut of phase 6c,
   "materialized" then "recompute": equal iteration counts and fits bit
   for bit, every lookup exact, no autotune, each engine run's launches
   and routes its buckets' picks; printed: models/s, TFLOP/s, and the
   measured peak of allocated bytes beside the reckoned bytes. The figures
   (plot_experiments.py) of phase 6c's quick experiments.json and phase
   6f's profile.json where matplotlib is installed (five PNGs, each
   non-empty), else the line "figures: matplotlib not installed". The
   phase's seconds and the run's so far are printed.
6h. cube500's MTTKRP launches (cube500_mttkrp_phase): the tensor-core
   MTTKRP at "high" on a 500^3 tensor at each (B, R) of the
   cube500.select50_high cell's launches (96x4, 96x8, 64x16, 32x16, 64x20,
   16x20) and every mode, with the planner's plans: held against its plain
   version at TOL["mttkrp"] and timed replayed from a CUDA graph beside
   the one-wave plan (ops/fused_mttkrp.py: one_wave_tc). The phase's own
   counts must hold mttkrp.tc_balanced > 0, one for each launch whose j
   splits fill more than one wave (96x4, 96x8 and 64x20: 9 of 18).
7. Probe: the launch-overhead probe (cp_cals_tpu_torch/probe_overhead.py),
   eager and graph-captured; its copy kernel is held to exact equality and
   timed beside torch.mul, eager and replayed.
8. Result: the graph captures, replays and stats fetches of each run, one
   {"kernels": [...]} line (the normal inverse and the apply also at K = 3,
   as "normal_inverse_k3" and "epilogue_apply_k3", at the 4-D run's launch
   mix; each rank's launches in phase 5c's runs as
   "multi_device_launches"; each kernel's launches in the experiment
   harness's engine runs as "experiments_launches", and in the stress
   phase's float32 runs as "stress_launches", in the studies phase's
   float32 runs as "study_launches", in each profile's run as
   "profile_launches", and in phase 6g's external study as
   "scripts_launches"), the run's seconds, then the last line
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
device's time); "library_graph_ms" the same for the PyTorch yardstick
(for the inverses torch.linalg.inv_ex at R <= 16, the mean over those
(B, R) only: INV_EX_CAPTURE_R).
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

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
# - apply_err_sq: the apply's error on a run's own inputs (the entry
#   points' launch mixes), where the models may fit the CLI's exact rank-5
#   target to a few 1e-6: err^2 = |X|^2 + term2 - 2 term3 then cancels to
#   almost nothing, and F and the gramian's fp32 roundings (a few 1e-7 of
#   each term, terms the size of |X|^2) set the difference of the two
#   versions' err^2. It is held relative to |X|^2, not to err^2.
TOL = {"mttkrp": 2e-5, "hinv": 1e-6, "apply": 1e-5, "apply_err": 1e-5, "apply_err_sq": 1e-5}
# The N-D slice: the bench tensor with a fourth mode of 8 (29.5 M entries,
# 118 MB in float32), the same queue and buckets; every mode takes the
# table's twostep or krp_gemm, and every normal matrix and FastALS error multiplies K = 3 other
# gramians. The widened epilogue kernels are also held at K = 4 (a fifth
# mode of 5), on the same tolerances as at K = 2.
MODES4 = MODES + (8,)
WIDE = {3: MODES4, 4: MODES4 + (5,)}
# Engine against the port's float64 CPU run (20 models, 10 iterations from
# the same inits): the largest |fit difference| and relative reconstruction
# difference allowed, per run. Both runs are deterministic; on an H100 they
# read 5.1e-6 / 8.2e-6 ("highest") and 1.6e-3 / 1.2e-3 (bench tiers, whose
# bf16 MTTKRP inputs carry 2^-9 relative rounding). The headline leg (50
# forced iterations, one polish sweep at "high", float16 wire) reads
# 1.2e-5 / 1.0e-3.
CROSS_TOL = {"highest": (5e-5, 5e-5), "bench-tiers": (1e-2, 1e-2), "headline": (1e-4, 5e-3)}
# The 3-D runs through the other MTTKRP routes at "highest" are held to the
# "highest" run's limits: each computes the same products in another order.
CROSS_TOL.update({"twostep": CROSS_TOL["highest"], "krp_gemm": CROSS_TOL["highest"],
                  "dimtree": CROSS_TOL["highest"]})
# The 4-D runs against the port's float64 CPU run of the same settings (one
# model per bucket, 10 iterations from the same inits): the largest
# |difference of the fits from the dense reconstructions| and relative
# reconstruction difference allowed, on the ranks held. "highest" reads
# 2.7e-6 / 1.7e-4 on an H100, where the port's float32 CPU run reads
# 2.3e-7 / 9.3e-5 against the same reference: float32 rounding moves these
# rank-4 to -20 models of a rank-5 tensor along directions the fit barely
# sees. At the bench tiers the twostep's bf16 products drive the models of
# rank above the tensor's 5 into two-factor degeneracy within 10
# iterations (negative dense fits on the card and in float64), where the
# two runs part ways; only the rank-4 model is held there, and even it moves
# by the bf16 roundings of the factors in every product and of both
# intermediates: 1.9e-2 / 9.2e-2 against the float64 run of the same
# tiers with the twostep on every mode, whose fit (0.4865) the card's
# (0.5056) and "highest"'s (0.5140) bracket. The limits give that reading
# 2.5x room. Under the lookup table (krp_gemm on mode 0, the CPU run taking
# the card's picks) it reads 7.5e-4 / 1.3e-2; "highest" 5.0e-7 / 8.4e-5.
ND_CROSS_TOL = {"4-D highest": (5e-5, 1e-3), "4-D bench-tiers": (5e-2, 2.5e-1)}
ND_HELD_RANKS = {"4-D highest": BUCKETS, "4-D bench-tiers": (4,)}
# A float64 problem on the card against the same run on the CPU: the two
# sum in other orders in float64.
F64_TOL = (1e-10, 1e-9)
HEADLINE = dict(max_iterations=50, polish_iters=1, result_wire_dtype="float16")
HINV_SNAPSHOTS = (1, 4, ITERS)  # engine iterations whose grams are checked
# The jackknife phase: the bench tensor's rank-5 model (fitted from this
# seed), its 299 replicates in one bucket of rank 8 (B = 320 slots).
JK_RANK, JK_BUCKET, JK_SEED = 5, 8, 17
# Rescaled, LSAP-adjusted replicates after 10 forced iterations on the card
# ("high" tier, float16 result wire) against the port's float64 CPU run of
# the same 10 fibers: the largest relative reconstruction difference (NaN
# row dropped) and the largest relative |lam| difference allowed. Both runs
# are deterministic; on an H100 J1 and J2 both read 3.2e-4 and 7.6e-5 (the
# float16 wire's 2^-11 rounding of the factors dominates). J4 (the fast
# tier, polished to polish_tol at "high") is held to the same limits.
JK_CROSS_TOL = (2e-3, 5e-4)
# J4: the bench's --fast jackknife tier (bench.py: tol_check_interval=5,
# polish to polish_tol=1e-6 in at most 25 sweeps, bf16 MTTKRP).
J4 = dict(mttkrp_precision="default", tol_check_interval=5, polish_iters=25, polish_tol=1e-6)
# The replicates cross-checked against the port's float64 CPU runs.
JK_FIBERS = [int(f) for f in np.linspace(0, MODES[0] - 1, 10).round()]
# J4 as the bench runs it (tol-driven, polished) with float32 results,
# against the port's float64 CPU run of the same settings on JK_FIBERS: each
# replicate's stop within one check window (5 iterations) of the CPU
# run's, and the largest |fit difference| and relative reconstruction
# difference (NaN row dropped) allowed. On an H100 the stops read 6 of 10
# equal and 4 iterations apart at most (fp32 rounding of the checked fit
# moves a stop by a check), fits 7.7e-6 and reconstructions 5.3e-6: the
# polish takes both runs to one fixed point. Without its polish the card's
# run reads 1.4e-4, which the reconstruction limit must refuse.
J4_STOP_TOL = (5e-5, 3e-5)
# The README command's best model of each rank (fp32 at "highest", stopped
# by tol 1e-6 on the CLI's exact rank-5 target) against the port's float64
# CPU run from the same init, forced to the card's iteration count: the
# largest |fit difference| and relative reconstruction difference allowed.
# On an H100 they read 3.3e-4 and 2.1e-5. The reconstructions agree; the
# fits of the models that fit the target to near 1 (ranks 10-17) differ
# by 2e-4 because the engine's fp32 FastALS error cancels there: err^2 is
# a difference of terms the size of |X|^2, whose fp32 roundings (a few
# 1e-7 of |X|^2) leave about 3e-4 |X| in err. The limits give the
# readings 3x and 5x room.
CLI_CROSS_TOL = (1e-3, 1e-4)


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


# torch.linalg.inv_ex, the inverses' yardstick, can be captured into a CUDA
# graph at R <= 16 only: above, the card's PyTorch (2.11) takes an LU path
# that is not capturable (R = 20 raised cudaErrorStreamCaptureUnsupported),
# so its replayed time is not measured there. torch.linalg.inv reads its
# error flags on the host and is timed eagerly.
INV_EX_CAPTURE_R = 16


def inv_ex_graph_ms(h) -> float | None:
    return graph_ms(lambda: torch.linalg.inv_ex(h)) if h.shape[-1] <= INV_EX_CAPTURE_R else None


def bound(flops: float, kind: str, nbytes: float) -> dict:
    """The least time for the work: operations over the card's peak rate of
    their type (``kind`` "fp32" on the CUDA cores, "bf16" on the tensor
    cores), or bytes (inputs read once, outputs written once) over HBM; the
    peaks are cp_cals_tpu_torch/utils/roofline.py's."""
    from cp_cals_tpu_torch.utils.roofline import device_peaks

    peaks = device_peaks(0)
    if peaks is None:
        raise AssertionError(f"no peaks known for {torch.cuda.get_device_name(0)} (utils/roofline.py: PEAKS)")
    t_ops = flops / (peaks[f"{kind}_tflops"] * 1e12) * 1e3
    t_bytes = nbytes / (peaks["hbm_tb_s"] * 1e12) * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> tuple[float, float]:
    err = (got.double() - want.double()).abs().max().item()
    return err, want.abs().max().item()


def bench_tensor(modes=MODES):
    """The bench workload's tensor: rank-5 model + 5% noise, seed 42
    (bench.py: build_workload); ``MODES4`` gives it a fourth mode."""
    from cp_cals_tpu_torch import random_ktensor_host

    rng = np.random.default_rng(42)
    kt = random_ktensor_host(rng, modes, 5, dtype=np.float32)
    x = np.einsum(",".join("ijkl"[n] + "r" for n in range(len(modes))) + ",r->" + "ijkl"[:len(modes)],
                  *kt.factors, kt.lam)
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


def cancelling_norms(g, hinv, iters, jk, zero_jk, others):
    """Model norms for the apply's error check: |X|^2 = 2 term3 - term2 +
    0.035 (|term2| + 2 |term3|), the terms of the plain version's error in
    float64 (``others`` the other modes' gramians), so that err^2 is 3.5 %
    of their size (0 for a dead slot)."""
    from cp_cals_tpu_torch.ops import fused_epilogue as fe

    f, lam, gm, _ = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk)
    h = gm.double()
    for o in others:
        h = h * o.double()
    lam = lam.double()
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
                peak = "fp32" if tier == "highest" else "bf16"
                row["mttkrp"][tier] = dict(
                    **bound(flops * (3 if tier == "high" else 1), peak, nbytes),
                    max_abs_err=err, ref_max=scale, library_err=lib_err,
                    ms=cuda_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
                    graph_ms=graph_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
                    plain_ms=cuda_ms(lambda: fm.fused_mttkrp_plain(x3, u1, u2, tier)),
                    library_ms=cuda_ms(library),
                    library_graph_ms=graph_ms(library),
                )
            # The port's twostep and krp_gemm at the same shapes, beside the
            # fused kernels.
            row["methods"] = mttkrp_methods_row(x, mode, factors)
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
                **bound(b * (4 * r**3 + 5 * r * r), "fp32", 4 * 3 * b * r * r + b * r),
                path=inverse_path(b, r), max_abs_err=max(c["max_abs_err"] for c in checks),
                ratio=max(c["ratio"] for c in checks),
                cond_max=max(c["cond_max"] for c in checks), checks=checks,
                ms=cuda_ms(lambda: fe.normal_inverse(e_grams, e_mask, mode)),
                graph_ms=graph_ms(lambda: fe.normal_inverse(e_grams, e_mask, mode)),
                plain_ms=cuda_ms(lambda: fe.normal_inverse_plain(e_grams, e_mask, mode)),
                library_ms=cuda_ms(lambda: torch.linalg.inv(h)),
                library_graph_ms=inv_ex_graph_ms(h),
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
                    x_norm = cancelling_norms(g, hinv, iters, jk, zero_jk, grams[:2])
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
                **bound(flops, "fp32", nbytes),
                max_abs_err=max(errs), max_err_rel=max(err_errs), with_err=with_err,
                ms=cuda_ms(lambda: fe.epilogue_apply(g, hinv, iters, jk, False, err_inputs)),
                graph_ms=graph_ms(lambda: fe.epilogue_apply(g, hinv, iters, jk, False, err_inputs)),
                plain_ms=cuda_ms(lambda: fe.epilogue_apply_plain(g, hinv, iters, jk, False, err_inputs)),
                library_ms=None, library_graph_ms=None,
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
                  f"(graph {row['apply']['graph_ms']:.4f}, error {with_err}); "
                  + ", ".join(f"{k} {v['ms']:.4f}ms (graph {v['graph_ms']:.4f})" for k, v in row["methods"].items()),
                  flush=True)
    return rows, worst


# ------------------------------------------------------------ table phase


def auto_tables() -> list:
    """(modes, tier, {bucket rank: batch}) of every bucket this script runs
    under AUTO on the card, from the engine's allocation: the entries the
    committed tables hold (``python3 tools/lut_tables.py`` measures them).
    The bench workload (3-D at "highest", at the bench tiers' "default" and
    the headline's polish at "high"; 4-D at "highest" and "default"), the
    NNLS run at "high", and the README command's CALS and jackknife buckets
    (``CalsParams`` defaults: buckets 4/8/16/32, buffer 4200) at "highest"
    and its --fast tier at "default"; and the experiment harness's buckets
    (``experiment_tables``)."""
    from cp_cals_tpu_torch import CalsParams

    d = CalsParams()
    models = [r for r in range(1, 21) for _ in range(20)]
    bench = engine_batches(models, BUCKETS, BUFFER)
    cli = engine_batches(models, d.bucket_ranks, d.buffer_size)
    cli_jk = engine_batches([r for r in range(1, 21) for _ in range(MODES[0])], d.bucket_ranks, d.buffer_size)
    nn = engine_batches([r for r in range(1, 11) for _ in range(10)], NN_BUCKETS, nn_params().buffer_size)
    return [(MODES, "highest", bench), (MODES, "default", bench), (MODES, "high", bench),
            (MODES4, "highest", bench), (MODES4, "default", bench), (NN_MODES, "high", nn),
            (MODES, "highest", cli), (MODES, "default", cli), (MODES, "highest", cli_jk)] + experiment_tables()


def table_phase(dev) -> dict:
    """``utils/lut.autotune`` on the card into a scratch root (the committed
    tables stay as they are): the bench workload's buckets (the engine's
    allocation for buffer_size=2880) at "highest" and "default", and the
    4-D bench tensor's at "default". Each mode's winner, each candidate's
    replayed ms per call, the committed table's pick and the fixed rule's
    (``heuristic_methods``) beside it; the phase's seconds."""
    import shutil

    from cp_cals_tpu_torch.utils import lut

    root = os.path.join("build", "chip_smoke_lut")
    shutil.rmtree(root, ignore_errors=True)
    committed_root, bench = lut._ROOT, engine_batches([r for r in range(1, 21) for _ in range(20)], BUCKETS, BUFFER)
    entries = []
    t0 = time.perf_counter()
    try:
        for modes, tier in ((MODES, "highest"), (MODES, "default"), (MODES4, "default")):
            for r, b in sorted(bench.items()):
                lut._ROOT = root
                winners = lut.autotune(modes, r, b, precision=tier, device=dev)
                lut._ROOT = committed_root
                committed = lut._load(modes, dev)
                fixed = lut.heuristic_methods(modes, r, b, tier, torch.float32, dev)
                for n, m in enumerate(winners):
                    key = lut._key(b, r, n, tier)
                    entries.append(dict(modes="-".join(map(str, modes)), tier=tier, B=b, R=r, mode=n, pick=m,
                                        ms=lut.LAST_TIMES[key], committed=committed.get(key), fixed_rule=fixed[n]))
                    e = entries[-1]
                    print(f"table {e['modes']} {tier} B={b} R={r} mode {n}: {m} ("
                          + ", ".join(f"{k} {v:.4f}" for k, v in e["ms"].items())
                          + f" ms replayed); committed {e['committed']}, fixed rule {e['fixed_rule']}", flush=True)
    finally:
        lut._ROOT = committed_root
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    out = dict(seconds=seconds, entries=entries,
               same_as_committed=sum(e["pick"] == e["committed"] for e in entries),
               off_the_fixed_rule=sum(e["pick"] != e["fixed_rule"] for e in entries))
    print(f"table phase: {len(entries)} modes tuned in {seconds:.1f}s; {out['same_as_committed']} picks as the "
          f"committed tables', {out['off_the_fixed_rule']} off the fixed rule", flush=True)
    return out


# ------------------------------------------------------------ engine phase


def engine_queue(rng, modes=MODES):
    from cp_cals_tpu_torch import random_ktensor_host

    return [
        random_ktensor_host(rng, modes, r, dtype=np.float32)
        for r in range(1, 21) for _ in range(20)
    ]


def reset_counts():
    """Every kernel wrapper's launch counts to 0 (cp_cals_tpu_torch/launches.py)."""
    from cp_cals_tpu_torch import launches

    launches.reset()


def read_counts() -> dict:
    """Each wrapper's launches by kernel name; the MTTKRPs' predicated
    launches apart, as "<name>.predicated"."""
    from cp_cals_tpu_torch import launches

    return launches.read()


MTTKRP_KERNEL = {"highest": "fused_mttkrp_fp32", "high": "fused_mttkrp_tc", "default": "fused_mttkrp_tc"}


def fused(tier: str, n_modes: int = 3, mttkrp_modes: int | None = None) -> dict:
    """The kernels one bucket-iteration of the fused-epilogue path launches,
    and how often: per mode the MTTKRP kernel of the MTTKRP's tier (on
    ``mttkrp_modes`` of the modes: all by default; None of them where
    the twostep computes every mode), then the epilogue."""
    out = {"normal_inverse": n_modes, "epilogue_apply": n_modes}
    m = n_modes if mttkrp_modes is None else mttkrp_modes
    if m:
        out[MTTKRP_KERNEL[tier]] = m
    return out


def unfused(tier: str) -> dict:
    """... of the unfused path through the SPD-inverse kernel."""
    return {MTTKRP_KERNEL[tier]: 3, "spd_inverse": 3}


def check_counts(name: str, counts: dict, kernels: dict, predicated: dict) -> None:
    """Each kernel of ``kernels`` launched that many times, at least once,
    every other kernel not at all; each MTTKRP kernel's predicated launches
    (the mixed-tier check's, once per bucket-iteration) as ``predicated``
    says, none elsewhere."""
    for k, v in counts.items():
        if k.endswith(".predicated"):
            want = predicated.get(k.removesuffix(".predicated"), 0)
        else:
            want = kernels.get(k, 0)
        if v != want or (k in kernels and v == 0):
            raise AssertionError(f"{name}: {k} launched {v} times, expected {want} ({kernels}, "
                                 f"predicated {predicated})")


def check_launches(name: str, counts: dict, per_step: dict, steps: int, checked: str | None = None,
                   checks: int = 0) -> None:
    """Each kernel of ``per_step`` launched its count x ``steps`` times
    (bucket-iterations and polish sweeps), every other kernel not at all;
    the predicated launches of the mixed-tier check's MTTKRP (kernel
    ``checked``) ``checks`` times, once per bucket-iteration."""
    check_counts(name, counts, {k: v * steps for k, v in per_step.items()}, {checked: checks} if checked else {})


def check_route_counts(name: str, routes: dict, want: dict) -> None:
    """The MTTKRP results by route (``launches.routes``) as ``want`` says,
    every other route none."""
    want = {k: want.get(k, 0) for k in routes}
    if routes != want:
        raise AssertionError(f"{name}: MTTKRP routes {routes}, expected {want}")


def check_routes(name: str, routes: dict, per_step: dict, steps: int) -> None:
    """The MTTKRP results by route: each route of ``per_step`` its count x
    ``steps``, every other none."""
    check_route_counts(name, routes, {k: v * steps for k, v in per_step.items()})


# ------------------------------------------------------- the lookup table


def pinned(**kw) -> dict:
    """``kw`` with the MTTKRP pinned to the fused kernels (a mode their gate
    refuses takes the twostep): the phases that test a kernel's launches
    run so; the main path's runs resolve AUTO from the lookup table."""
    from cp_cals_tpu_torch import MttkrpMethod

    return dict(mttkrp_method=MttkrpMethod.PALLAS, **kw)


def engine_batches(ranks, bucket_ranks, buffer_size) -> dict:
    """{bucket rank: batch}, the engine's allocation for a queue of
    ``ranks`` (solvers/cals.py: bucket_rank, allocate_bucket_batches)."""
    from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches, bucket_rank

    demands = collections.Counter(bucket_rank(r, bucket_ranks) for r in ranks)
    out = {}
    for wave in allocate_bucket_batches(dict(demands), buffer_size):
        out.update(wave)
    return out


def bucket_picks(modes, ranks, params) -> dict:
    """{bucket rank: (fast-tier methods, polish methods or None)} as the
    engine resolves them on the card under AUTO for a queue of ``ranks``
    (solvers/cals.py: _resolve_bucket_methods, after the run that ensured
    the entries: exact hits), leaving LOOKUP_STATS as it was."""
    from cp_cals_tpu_torch.solvers.cals import _resolve_bucket_methods
    from cp_cals_tpu_torch.utils import lut

    saved = dict(lut.LOOKUP_STATS)
    try:
        return {r: _resolve_bucket_methods(tuple(modes), r, b, params, torch.float32, "cuda")
                for r, b in engine_batches(ranks, params.bucket_ranks, params.buffer_size).items()}
    finally:
        lut.LOOKUP_STATS.update(saved)


def table_counts(picks: dict, rep, params, n_modes: int, epilogue: bool = True) -> tuple[dict, dict, dict]:
    """What a run under AUTO must launch, from its buckets' picks: the
    MTTKRP kernel of each tier on every mode picked "pallas" (the fast
    tier's per bucket-iteration, the polish tier's per polish sweep), the
    mixed-tier check's last-mode MTTKRP per bucket-iteration where it runs
    (not under forced iterations; a predicated launch where it is fused),
    and with ``epilogue`` the normal inverse and
    the apply on every mode of every step. Returns (kernels, predicated,
    routes)."""
    kernels, predicated, routes = collections.Counter(), collections.Counter(), collections.Counter()
    fast = params.mttkrp_precision or params.precision
    for r, (methods, polish) in picks.items():
        iters = rep.engine_iterations.get(r, 0)
        sweeps = rep.loop_counts.get(r, {}).get("polish_sweeps", 0)
        for tier, ms, steps in ((fast, methods, iters), (params.precision, polish or methods, sweeps)):
            for m in ms:
                routes["fused" if m == "pallas" else m] += steps
                if m == "pallas":
                    kernels[MTTKRP_KERNEL[tier]] += steps
        if params.tol_check_interval > 0 and not params.force_max_iter:
            routes["fused" if methods[-1] == "pallas" else methods[-1]] += iters
            if methods[-1] == "pallas":
                predicated[MTTKRP_KERNEL[params.precision]] += iters
        if epilogue:
            kernels["normal_inverse"] += n_modes * (iters + sweeps)
            kernels["epilogue_apply"] += n_modes * (iters + sweeps)
    return dict(kernels), dict(predicated), dict(routes)


def lut_stats(name: str) -> dict:
    """The lookup decisions of the run just made under AUTO: no mode may
    have fallen to the heuristic (the committed tables, or on another card
    the autotune, cover every bucket)."""
    from cp_cals_tpu_torch.utils import lut

    stats = dict(lut.LOOKUP_STATS)
    if stats["heuristic"]:
        raise AssertionError(f"{name}: {stats['heuristic']} MTTKRP dispatch decisions fell to the heuristic "
                             f"({stats})")
    return stats


def check_table_run(name: str, modes, ranks, params, rep, counts: dict, routes: dict,
                    epilogue: bool = True) -> dict:
    """A run under AUTO: no heuristic decision, and its launches and MTTKRP
    results by route equal its buckets' picks (``table_counts``). Returns
    the lookup decisions and the picks, for the record."""
    stats = lut_stats(name)
    picks = bucket_picks(modes, ranks, params)
    kernels, predicated, want_routes = table_counts(picks, rep, params, len(modes), epilogue)
    check_counts(name, counts, kernels, predicated)
    check_route_counts(name, routes, want_routes)
    print(f"{name}: lookup {stats}; picks by bucket "
          + ", ".join(f"{r}: {'/'.join(m)}" + (f" (polish {'/'.join(p)})" if p else "")
                      for r, (m, p) in sorted(picks.items())), flush=True)
    return dict(lut_dispatch=stats, picks={str(r): [list(m), list(p) if p else None] for r, (m, p) in picks.items()})


def card_picks(picks: dict):
    """A context in which the engine runs each bucket of rank r with
    ``picks[r]`` (a card run's ``bucket_picks``): the CPU reference of a run
    under AUTO takes the card's methods, whatever its own buckets'
    batches."""
    import contextlib

    from cp_cals_tpu_torch.solvers import cals

    @contextlib.contextmanager
    def ctx():
        real = cals._resolve_bucket_methods
        cals._resolve_bucket_methods = lambda shape, r, b, params, *a, **k: picks[r]
        try:
            yield
        finally:
            cals._resolve_bucket_methods = real

    return ctx()


def loop_totals(rep) -> dict:
    """A run's graph captures and replays, stats fetches and polish sweeps,
    over its buckets."""
    out = dict(captures=0, replays=0, stats_fetches=0, polish_sweeps=0)
    for counts in rep.loop_counts.values():
        for k in out:
            out[k] += counts[k]
    return out


def bench_params(**kw):
    """The bench workload's engine settings, with ``kw`` (precision tiers,
    and the headline leg's depth, polish and wire) over them."""
    from cp_cals_tpu_torch import CalsParams

    base = dict(max_iterations=ITERS, force_max_iter=True, bucket_ranks=BUCKETS,
                buffer_size=BUFFER, tail_compaction_depth=0, tol=1e-6)
    return CalsParams(**{**base, **kw})


def engine_run(x, queue, tiers: dict, name: str, check_fit: bool = True, per_step: dict | None = None,
               routes: dict | None = None, checked: str | None = None, **kw):
    """One cp_cals run from counts at 0 and no kept graphs (it captures its
    own, as its checks of captures and eager inputs expect). Under AUTO (unless ``kw`` pins a
    method) its launches and routes must equal its buckets' picks from the
    lookup table, with no heuristic decision (``check_table_run``). With a
    pinned method: ``per_step`` the kernels of its path and their launches
    per bucket-iteration (default: the 3-D fused path), ``routes`` its
    MTTKRP results by route (default: the fused kernels on all three
    modes), ``checked`` the MTTKRP kernel launched under a device predicate
    once per bucket-iteration (none by default)."""
    from cp_cals_tpu_torch import cp_cals, launches, release_graphs
    from cp_cals_tpu_torch.utils import lut

    params = bench_params(**tiers, **kw)
    release_graphs()
    torch.cuda.synchronize()
    reset_counts()
    lut.reset_lookup_stats()
    t0 = time.perf_counter()
    results, rep = cp_cals(x, queue, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bucket_iters = sum(rep.engine_iterations.values())
    loop = loop_totals(rep)
    steps = bucket_iters + loop["polish_sweeps"]
    route_counts = launches.routes()
    table = {}
    if params.mttkrp_method.value == "auto":
        if per_step or routes or checked:
            raise ValueError(f"{name}: a run under AUTO takes its counts from the table's picks")
        table = check_table_run(name, x.shape, [kt.rank for kt in queue], params, rep, counts, route_counts)
    else:
        check_launches(name, counts, per_step or fused(params.mttkrp_precision or params.precision), steps,
                       checked, bucket_iters if checked else 0)
        check_routes(name, route_counts, routes or {"fused": 3}, steps)
    if len(results) != len(queue) or any(kt is None for kt in results):
        raise AssertionError(f"{name}: missing results")
    for kt, q in zip(results, queue):
        if tuple(f.shape for f in kt.factors) != tuple(f.shape for f in q.factors):
            raise AssertionError(f"{name}: result shapes differ from the queue's")
        if not all(np.isfinite(f).all() for f in kt.factors) or not np.isfinite(kt.lam).all():
            raise AssertionError(f"{name}: non-finite factors")
    fits = np.array([m.fit for m in rep.models])
    iters = np.array([m.iters for m in rep.models])
    if (not np.isfinite(fits).all() or fits.max() > 1.0 or (iters != params.max_iterations).any()
            or (check_fit and fits.mean() < 0.5)):
        raise AssertionError(f"{name}: fits {fits.mean()} iters {set(iters.tolist())}")
    out = dict(
        wall_s=wall, models_per_s=len(queue) / wall, mean_fit=float(fits.mean()),
        mean_iters=float(iters.mean()), bucket_iterations=rep.engine_iterations,
        launches=counts, routes=route_counts, phase_times={str(k): v for k, v in rep.phase_times.items()},
        loop=loop, sync_mode=params.sync_mode, **table,
    )
    print(f"engine {name}: wall {wall:.3f}s, {out['models_per_s']:.1f} models/s, "
          f"mean fit {out['mean_fit']:.6f}, mean iters {out['mean_iters']}, "
          f"bucket-iterations {bucket_iters}, launches {counts}, MTTKRP routes {route_counts}", flush=True)
    print(f"engine {name} loop ({params.sync_mode}): {loop['captures']} graph captures, "
          f"{loop['replays']} replays, {loop['stats_fetches']} stats fetches, "
          f"{loop['polish_sweeps']} polish sweeps", flush=True)
    return results, rep, out


THREAD_TURNS = (1, 4, 4, 1, 1, 4)  # bucket_threads of phase 4a's runs, in turns


def tool(name: str):
    """The module tools/<name>.py of this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bucket_threads_phase(x_np, queue) -> dict:
    """Phase 4a (module docstring): serial and threaded buckets in turns,
    held bit for bit and count for count; walls, phase times, and a
    profiled run of each."""
    profile_engine = tool("profile_engine")
    out = {}
    for name, tiers in (("bench-tiers", BENCH_TIERS), ("highest", {})):
        runs = []
        for t in THREAD_TURNS:
            res, rep, run = engine_run(x_np, queue, tiers, f"{name} bucket_threads={t}", bucket_threads=t)
            runs.append((t, res, rep, run))
        _, res1, rep1, run1 = runs[0]

        def per_bucket(rep):
            return {r: {k: c[k] for k in ("captures", "replays", "stats_fetches", "polish_sweeps")}
                    for r, c in rep.loop_counts.items()}

        for t, res, rep, run in runs[1:]:
            label = f"{name}: bucket_threads={t} vs the first serial run"
            assert_bit_identical(label, (res1, rep1), (res, rep))
            if (run["launches"], run["routes"], per_bucket(rep)) != (run1["launches"], run1["routes"],
                                                                      per_bucket(rep1)):
                raise AssertionError(f"{label}: launches {run['launches']} routes {run['routes']} loop "
                                     f"{per_bucket(rep)} vs {run1['launches']} {run1['routes']} {per_bucket(rep1)}")
        walls = {t: [r[3]["wall_s"] for r in runs if r[0] == t] for t in (1, 4)}
        phases = {t: [{str(b): pt for b, pt in r[2].phase_times.items()} for r in runs if r[0] == t]
                  for t in (1, 4)}
        prof = {}
        for t in (1, 4):
            _, _, summary = profile_engine.profile_run(torch.from_numpy(x_np).cuda(), queue,
                                                          bench_params(**tiers, bucket_threads=t))
            prof[t] = {k: summary[k] for k in ("wall_s", "device_busy_ms", "device_busy_share", "host_launch_ms",
                                               "host_sync_ms", "kernels_launched")}
        for t in (1, 4):
            med = sorted(walls[t])[1]
            print(f"bucket threads {name} t={t}: walls {walls[t]} s (median {med:.4f}), "
                  f"profiled: wall {prof[t]['wall_s']:.4f}s, device busy {prof[t]['device_busy_ms']:.2f} ms "
                  f"= {prof[t]['device_busy_share']:.3f} of wall, host in launch calls "
                  f"{prof[t]['host_launch_ms']:.2f} ms, in synchronising calls {prof[t]['host_sync_ms']:.2f} ms",
                  flush=True)
            print(f"bucket threads {name} t={t} phase times (s, by bucket, last run): "
                  + "; ".join(f"{b}: " + ", ".join(f"{k} {v:.4f}" for k, v in pt.items())
                              for b, pt in phases[t][-1].items()), flush=True)
        out[name] = dict(turns=list(THREAD_TURNS), walls_s=walls, phase_times=phases,
                         profile=prof, launches=run1["launches"], routes=run1["routes"], loop=per_bucket(rep1))
    return out


def assert_bit_identical(name: str, a, b) -> None:
    """Every model's fit, iteration count, error and factors equal bit for
    bit between two engine runs (results, report)."""
    (res_a, rep_a), (res_b, rep_b) = a, b
    for ka, kb, ma, mb in zip(res_a, res_b, rep_a.models, rep_b.models):
        if (ma.id, ma.iters, ma.fit, ma.approx_error) != (mb.id, mb.iters, mb.fit, mb.approx_error):
            raise AssertionError(f"{name}: model {ma.id} differs: {ma} vs {mb}")
        for fa, fb in zip(ka.factors + (ka.lam,), kb.factors + (kb.lam,)):
            if not np.array_equal(fa, fb):
                raise AssertionError(f"{name}: model {ma.id}'s factors differ")
    print(f"{name}: {len(res_a)} models bit-identical (fits, iterations, factors)", flush=True)


def picks_of(run: dict) -> dict:
    """An engine run's picks by bucket rank, as ``card_picks`` takes them."""
    return {int(r): (tuple(m), tuple(p) if p else None) for r, (m, p) in run["picks"].items()}


def cross_check(x, queue, runs: dict, picks: dict | None = None, **kw) -> dict:
    """20 models (one per rank) of each engine run against the port's
    float64 CPU run from the same inits (``kw``: the runs' settings beside
    the bench's; ``picks``: a run's MTTKRP picks under AUTO, which the CPU
    run then takes, ``card_picks``): the largest |fit difference| and
    relative reconstruction difference, held to CROSS_TOL per run."""
    import contextlib

    from cp_cals_tpu_torch import Ktensor, cp_cals
    from cp_cals_tpu_torch.ktensor import to_tensor

    def dense(kt):
        return to_tensor(Ktensor(tuple(torch.from_numpy(f.astype(np.float64)) for f in kt.factors),
                                 torch.from_numpy(kt.lam.astype(np.float64))))

    pick = [20 * (r - 1) for r in range(1, 21)]
    q64 = [Ktensor(tuple(f.astype(np.float64) for f in queue[i].factors),
                   queue[i].lam.astype(np.float64)) for i in pick]
    with card_picks(picks) if picks else contextlib.nullcontext():
        res64, rep64 = cp_cals(x.astype(np.float64), q64, bench_params(**kw), device="cpu")
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

    base = pinned(tol=1e-6, max_iterations=100, buffer_size=4200, bucket_ranks=(JK_BUCKET,),
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


def copied(a):
    """A copy of a call's argument: tensors cloned, tuples and lists of
    them copied leaf by leaf, anything else as it is."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (tuple, list)):
        return type(a)(copied(v) for v in a)
    return a


class Recorder:
    """Observes the calls of one kernel's wrapper during one run, where the
    run makes them: ``module.attr`` is swapped for a recording function
    while the run lasts (the wrapper's own counts stay its own). Its
    tallies (``launches.Tally``, counted per thread) go into
    ``launches.TALLIES``, so a CUDA-graph replay advances them as it
    advances the wrappers' counts: ``shapes`` counts launches by ``key``,
    replays included. ``first`` holds copies of the first inputs of each
    key, taken at an eager call (the graph loop runs every captured
    iteration eagerly first, as its warm-up), the call's arguments in the
    order of ``key``'s parameters, defaults filled in; ``keep`` says which
    arguments stay by reference (ones nothing writes to). The engine's
    bucket threads call at once: a call is recorded under a lock, ``n``
    counts every call and ``mine()`` the calling thread's (a bucket's calls
    come in its thread in the iteration's order). The eager iterations of
    ``precompile_buckets`` (``solvers/cals.py:_warm_programs``, on zero
    models) are not the run's calls and are not recorded."""

    module, attr, keep, n_first = None, None, (), 3

    def key(self, *args):
        raise NotImplementedError

    def seen(self, n: int, captured: bool, args) -> None:
        """Every call's hook (``n`` counts the calls)."""

    def __enter__(self):
        import importlib

        from cp_cals_tpu_torch import launches

        from cp_cals_tpu_torch.solvers import cals

        self.mod = importlib.import_module(self.module)
        self.real = getattr(self.mod, self.attr)
        self.real_warm, self.warming = cals._warm_programs, False

        def warm(*a, **k):
            self.warming = True
            try:
                return self.real_warm(*a, **k)
            finally:
                self.warming = False

        cals._warm_programs = warm
        self.shapes, self.first, self.n = launches.Tally(), {}, 0
        self.lock, self.local = threading.Lock(), threading.local()
        self.tallies = [self.shapes]
        launches.TALLIES.extend(self.tallies)

        sig = inspect.signature(self.key)

        def record(*args, **kw):
            if self.warming:
                return self.real(*args, **kw)
            with self.lock:
                key = self.key(*args, **kw)
                if key is not None:
                    captured = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
                    self.shapes.add(key)
                    if key not in self.first and not captured:
                        bound = sig.bind(*args, **kw)
                        bound.apply_defaults()
                        self.first[key] = tuple(a if i in self.keep else copied(a)
                                                for i, a in enumerate(bound.args[:self.n_first]))
                    self.seen(self.n, captured, args)
                    self.n += 1
                    self.local.n = self.mine() + 1
            return self.real(*args, **kw)

        setattr(self.mod, self.attr, record)
        return self

    def mine(self) -> int:
        """The calls recorded so far in the calling thread."""
        return getattr(self.local, "n", 0)

    def __exit__(self, *exc):
        from cp_cals_tpu_torch import launches
        from cp_cals_tpu_torch.solvers import cals

        setattr(self.mod, self.attr, self.real)
        cals._warm_programs = self.real_warm
        for t in self.tallies:
            launches.TALLIES.remove(t)

    def check_total(self, name: str, launched: int) -> None:
        """The recorded launches, replays included, are the run's count."""
        total = sum(self.shapes.values())
        if total != launched or set(self.first) != set(self.shapes):
            raise AssertionError(f"{name}: {total} launches recorded in {sorted(self.shapes)}, "
                                 f"{launched} counted; eager inputs of {sorted(self.first)}")


class SpdRecorder(Recorder):
    """The unfused solve's calls of ``spd_inverse`` by (B, R), and every
    call's input H: a copy where the call ran eagerly, and where it was
    captured, the graph's own H buffer, which after the run holds that
    graph's last replay (kept where the graph was replayed: ``written``, a
    tally of one per eager call or replay)."""

    module, attr = "cp_cals_tpu_torch.ops.update", "spd_inverse"

    def __enter__(self):
        super().__enter__()
        from cp_cals_tpu_torch import launches

        self.calls, self.written = [], launches.Tally()
        self.tallies.append(self.written)
        launches.TALLIES.append(self.written)
        return self

    def key(self, h):
        return tuple(h.shape[:2])

    def seen(self, n, captured, args):
        (h,) = args
        self.written.add(n)
        self.calls.append((captured, self.mine() % 3, h if captured else h.clone()))  # modes in turn

    @property
    def snaps(self) -> list:
        """(label, H) of every eager call and of every captured call's last
        replay."""
        out = []
        for n, (captured, mode, h) in enumerate(self.calls):
            times = self.written.get(n, 0)
            if times:
                kind = f"last of {times} replays" if captured else "eager"
                out.append((f"{kind} B={h.shape[0]} mode {mode}", h))
        return out


class MttkrpRecorder(Recorder):
    """The unpredicated MTTKRP calls through the tier dispatcher
    ``fused_mttkrp`` on the bench tensor by (B, R, target mode, tier); the
    held layout X stays by reference."""

    module, attr, keep = "cp_cals_tpu_torch.ops.fused_mttkrp", "fused_mttkrp", (0,)

    def key(self, x3, u1, u2, precision="highest", pred=None, plan=None):
        # the target mode's I: [.., J, I, Kp] at the bf16 tiers, [J, K, I] at "highest"
        i = x3.shape[-1] if precision == "highest" else x3.shape[-2]
        return None if pred is not None else (u1.shape[0], u1.shape[2], MODES.index(i), precision)


class CubeMttkrpRecorder(MttkrpRecorder):
    """The same on a cube, whose modes have one length: the target mode is
    the call's place in its iteration (a run with no predicated call makes
    three per iteration, the modes in turn; where the table sends a mode
    off the fused kernels, the places shift, and every place of a cube has
    the same shapes)."""

    def key(self, x3, u1, u2, precision="highest", pred=None, plan=None):
        if pred is not None:
            raise AssertionError("a predicated MTTKRP call in a run recorded by its calls' order")
        return (u1.shape[0], u1.shape[2], self.mine() % 3, precision)


def jk_run(name: str, run, per_step: dict, checked: str | None = None) -> tuple:
    """One jackknife run from counts at 0 and no kept graphs: launches
    (with ``checked``, the mixed-tier check's MTTKRP kernel, one predicated
    launch per bucket-iteration), 299 well-formed replicates (factor 0 NaN
    exactly on its fiber's row, finite elsewhere, finite lam), wall and
    replicates/s."""
    from cp_cals_tpu_torch import release_graphs

    release_graphs()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bucket_iters = sum(rep.cals_report.engine_iterations.values())
    loop = loop_totals(rep.cals_report)
    check_launches(name, counts, per_step, bucket_iters + loop["polish_sweeps"], checked,
                   bucket_iters if checked else 0)
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
               bucket_iterations=rep.cals_report.engine_iterations, launches=counts, loop=loop,
               stats_fetches_per_replicate=loop["stats_fetches"] / len(reps))
    print(f"jackknife {name}: wall {wall:.3f}s, {out['replicates_per_s']:.1f} replicates/s, "
          f"mean iters {out['mean_iters']:.2f}, bucket-iterations {bucket_iters}, launches {counts}",
          flush=True)
    print(f"jackknife {name} loop: {loop['captures']} graph captures, {loop['replays']} replays, "
          f"{loop['stats_fetches']} stats fetches ({out['stats_fetches_per_replicate']:.4f} per replicate), "
          f"{loop['polish_sweeps']} polish sweeps", flush=True)
    return rep, out


def mttkrp_mix(rec, x, label="J1") -> list:
    """The MTTKRP kernel at every (B, R, mode, tier) of a recorded run on
    ``x``, on that run's own inputs: held against its plain version at
    TOL["mttkrp"] and timed, with the torch twostep at the same tier beside
    it."""
    from cp_cals_tpu_torch.ops import fused_mttkrp as fm

    modes = tuple(x.shape)
    mix = []
    for (b, r, mode, tier), n in sorted(rec.shapes.items(), reverse=True):
        x3, u1, u2 = rec.first[(b, r, mode, tier)]
        got, want = fm.fused_mttkrp(x3, u1, u2, tier), fm.fused_mttkrp_plain(x3, u1, u2, tier)
        torch.cuda.synchronize()
        err, scale = rel_err(got, want)
        if not err <= TOL["mttkrp"] * scale:
            raise AssertionError(f"fused_mttkrp {tier} B={b} R={r} mode={mode} ({label}'s recorded inputs): "
                                 f"{err} vs {scale}")
        small, big = fm.split_others(modes, mode)
        j, i, k = modes[small], modes[mode], modes[big]
        x_ts = x.permute(mode, small, big).reshape(-1, k)
        flops = (2 * j * i * k * b * r + 2 * j * i * b * r) * (3 if tier == "high" else 1)
        mix.append(dict(
            B=b, R=r, mode=mode, tier=tier, launches=n, max_abs_err=err, ref_max=scale,
            **bound(flops, "fp32" if tier == "highest" else "bf16", x3.nbytes + 4 * b * (j + k + i) * r),
            ms=cuda_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
            graph_ms=graph_ms(lambda: fm.fused_mttkrp(x3, u1, u2, tier)),
            plain_ms=cuda_ms(lambda: fm.fused_mttkrp_plain(x3, u1, u2, tier)),
            library_ms=cuda_ms(lambda: twostep(x_ts, u1, u2, tier)),
        ))
        m = mix[-1]
        print(f"mttkrp {label} mix {tier} B={b} R={r} mode={mode} ({n} launches): {m['ms']:.4f}ms "
              f"(graph {m['graph_ms']:.4f}), plain {m['plain_ms']:.4f}ms, twostep {m['library_ms']:.4f}ms, "
              f"bound {m['bound_ms']:.4f}ms, err/max {err / scale:.2e}", flush=True)
    return mix


CUBE500_LAUNCHES = ((96, 4), (96, 8), (64, 16), (32, 16), (64, 20), (16, 20))  # phase 6h's (B, R)


def cube500_mttkrp_phase(dev) -> list:
    """Phase 6h (module docstring): the tensor-core MTTKRP at cube500's
    launches, each checked, timed beside the one-wave plan, and counted."""
    from cp_cals_tpu_torch.ops import fused_mttkrp as fm
    from cp_cals_tpu_torch.utils import timers

    modes, tier, planes = (500, 500, 500), "high", fm.PLANES["high"]
    gen = torch.Generator(device=dev).manual_seed(500)
    x = torch.randn(modes, device=dev, generator=gen)
    index = torch.cuda.current_device()
    rows, several, balanced = [], 0, 0
    for mode in range(3):
        small, big = fm.split_others(modes, mode)
        x3 = fm.prepare_mode_tensor(x, mode, tier)
        j, i, kp = modes[small], modes[mode], x3.shape[-1]
        for b, r in CUBE500_LAUNCHES:
            u1 = torch.randn((b, j, r), device=dev, generator=gen)
            u2 = torch.randn((b, modes[big], r), device=dev, generator=gen)
            plan = fm.tc_plan(index, j, i, kp, b * r, planes)
            slots = fm._tc_slots(index, plan[0], planes, plan[1])
            wave = fm.one_wave_tc(plan[:3], j, i, b * r, slots)
            with timers.recording():  # this launch's own counts
                got = fm.fused_mttkrp(x3, u1, u2, tier)
            balanced += timers.counters().get("mttkrp.tc_balanced", 0)
            want = fm.fused_mttkrp_plain(x3, u1, u2, tier)
            torch.cuda.synchronize()
            err, scale = rel_err(got, want)
            if not err <= TOL["mttkrp"] * scale:
                raise AssertionError(f"fused_mttkrp {tier} 500^3 B={b} R={r} mode={mode} plan {plan}: "
                                     f"{err} vs {scale}")
            several += plan[3] > 1 and fm.tc_waves(plan, i, b * r, slots) > 1
            rows.append(dict(B=b, R=r, mode=mode, plan=list(plan), waves=fm.tc_waves(plan, i, b * r, slots),
                             max_abs_err=err, ref_max=scale,
                             graph_ms=graph_ms(lambda: fm.fused_mttkrp_tc(x3, u1, u2, tier, plan=plan)),
                             one_wave_plan=list(wave),
                             one_wave_graph_ms=graph_ms(lambda: fm.fused_mttkrp_tc(x3, u1, u2, tier, plan=wave))))
            m = rows[-1]
            print(f"mttkrp cube500 high B={b} R={r} mode={mode}: plan {plan} ({m['waves']} waves) "
                  f"{m['graph_ms']:.4f}ms graph-replayed, one wave {wave} {m['one_wave_graph_ms']:.4f}ms, "
                  f"err/max {err / scale:.2e}", flush=True)
        del x3
    if not 0 < balanced == several == 9:
        raise AssertionError(f"cube500 launches: mttkrp.tc_balanced {balanced}, over several waves {several}, "
                             f"9 expected")
    print(f"cube500 launches: {several} of {len(rows)} over several waves, mttkrp.tc_balanced {balanced}",
          flush=True)
    return rows


def jk_phase(x_np, kt5):
    from cp_cals_tpu_torch import AlsParams, jk_cp_batched_als, jk_cp_cals

    shared = pinned(tol=1e-6, max_iterations=100, precision="high", dimtree="off")
    runs = {}
    # J1's MTTKRP launches and J2's SPD inverses are recorded in the runs
    # themselves, replays included.
    with MttkrpRecorder() as j1_rec:
        _, runs["J1"] = jk_run("J1", lambda: jk_cp_cals(x_np, [kt5], jk_params()), fused("high"))
    j1_rec.check_total("J1's MTTKRP mix", runs["J1"]["launches"]["fused_mttkrp_tc"])
    with SpdRecorder() as rec:
        _, runs["J2"] = jk_run("J2", lambda: jk_cp_cals(x_np, [kt5], jk_params(solve_method="pallas")),
                               unfused("high"))
    rec.check_total("J2's SPD-inverse mix", runs["J2"]["launches"]["spd_inverse"])
    _, runs["J3"] = jk_run(
        "J3", lambda: jk_cp_batched_als(x_np, [kt5], AlsParams(**shared, solve_method="pallas")), unfused("high"))
    # J4: the fast MTTKRP at "default"; the check's and the polish's at "high".
    _, runs["J4"] = jk_run("J4", lambda: jk_cp_cals(x_np, [kt5], jk_params(**J4)), fused("default"),
                           checked="fused_mttkrp_tc")
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


def jk_reference(x_np, kt5, params):
    """The port's float64 CPU run of JK_FIBERS' replicates of ``kt5`` under
    ``params``, rescaled and LSAP-adjusted as jk_cp_cals returns them, and
    its engine report."""
    from cp_cals_tpu_torch import Ktensor, cp_cals
    from cp_cals_tpu_torch.solvers.jackknife import (
        _rescale_replicate,
        jk_permutation_adjustment,
        to_host_model,
    )

    ref = to_host_model(Ktensor(tuple(f.astype(np.float64) for f in kt5.factors), kt5.lam.astype(np.float64)))
    res64, rep64 = cp_cals(x_np.astype(np.float64), [ref] * len(JK_FIBERS), params, jk_fibers=JK_FIBERS,
                           device="cpu")
    return jk_permutation_adjustment(ref, [_rescale_replicate(k, f) for k, f in zip(res64, JK_FIBERS)]), rep64


def jk_cross_check(x_np, kt5) -> dict:
    """J1, J2 and J4 again at 10 forced iterations (J4 then polished)
    against the port's float64 CPU run of 10 fibers from the same model
    and settings, both rescaled and LSAP-adjusted: held to JK_CROSS_TOL."""
    from cp_cals_tpu_torch import jk_cp_cals

    def reference(**kw):
        return jk_reference(x_np, kt5, jk_params(force_max_iter=True, max_iterations=10, precision="highest",
                                                 result_wire_dtype=None, **kw))[0]

    plain, polished = reference(), reference(polish_iters=J4["polish_iters"], polish_tol=J4["polish_tol"])
    out = {}
    for name, kw in (("J1", {}), ("J2", dict(solve_method="pallas")), ("J4", J4)):
        want = polished if name == "J4" else plain
        rep = jk_cp_cals(x_np, [kt5], jk_params(force_max_iter=True, max_iterations=10, **kw))
        diffs = [replicate_diff(rep.results[0][f], w, f) for f, w in zip(JK_FIBERS, want)]
        rec, lam = max(d[0] for d in diffs), max(d[1] for d in diffs)
        print(f"cross-check {name} (10 forced iterations, 10 fibers) vs CPU float64: max relative "
              f"reconstruction diff {rec:.3e}, max relative |lam| diff {lam:.3e}", flush=True)
        rec_tol, lam_tol = JK_CROSS_TOL
        if not (rec <= rec_tol and lam <= lam_tol):
            raise AssertionError(f"jackknife cross-check of {name} against the CPU float64 run failed")
        out[name] = dict(max_rel_recon_diff=rec, max_rel_lam_diff=lam)
    return out


def j4_stop_check(x_np, kt5) -> dict:
    """J4 as the bench runs it, its stops decided by the mixed-tier checks
    and then polished to polish_tol, with the result wire off, against the
    port's float64 CPU run of the same settings: held to J4_STOP_TOL. The
    same run without its polish must fail the reconstruction limit."""
    from cp_cals_tpu_torch import jk_cp_cals

    params = jk_params(result_wire_dtype=None, **J4)
    want, rep64 = jk_reference(x_np, kt5, params)
    out = {}
    for name, p in (("J4 stop", params), ("J4 stop, unpolished", dataclasses.replace(params, polish_iters=0))):
        rep = jk_cp_cals(x_np, [kt5], p)
        models = {m.id: m for m in rep.cals_report.models}
        got = [models[f] for f in JK_FIBERS]
        iters = [(m.iters, m64.iters) for m, m64 in zip(got, rep64.models)]
        res = dict(
            iters=iters, max_iter_diff=max(abs(a - b) for a, b in iters),
            exact_stops=sum(a == b for a, b in iters),
            max_fit_diff=max(abs(m.fit - m64.fit) for m, m64 in zip(got, rep64.models)),
            max_rel_recon_diff=max(replicate_diff(rep.results[0][f], w, f)[0] for f, w in zip(JK_FIBERS, want)),
        )
        print(f"cross-check {name} (tol-driven, float32 results, 10 fibers) vs CPU float64: stops (card, CPU) "
              f"{iters}, {res['exact_stops']} equal; max |fit diff| {res['max_fit_diff']:.3e}, max relative "
              f"reconstruction diff {res['max_rel_recon_diff']:.3e}", flush=True)
        out[name] = res
    fit_tol, rec_tol = J4_STOP_TOL
    res = out["J4 stop"]
    if not (res["max_iter_diff"] <= J4["tol_check_interval"] and res["max_fit_diff"] <= fit_tol
            and res["max_rel_recon_diff"] <= rec_tol):
        raise AssertionError(f"J4's tol-driven cross-check against the CPU float64 run failed: {res}")
    if out["J4 stop, unpolished"]["max_rel_recon_diff"] <= rec_tol:
        raise AssertionError("J4's tol-driven cross-check: the run without its polish passes the limit")
    return out


def spd_phase(rec, dev) -> dict:
    """The SPD-inverse kernel against its plain version on the card: on the
    normal matrices J2 inverted (every eager call's, the warm-up iteration
    before each capture, and each captured call's last replay), and on
    random SPD batches at R = 4, 20, 32, 33, 64 (both paths of
    csrc/gj_elim.cuh and their boundary) with condition numbers up to about
    1e4 and dead identity slots. Times at every (B, R) of J2's launch mix."""
    from cp_cals_tpu_torch.ops import spd_inverse as si

    gen = np.random.default_rng(13)
    cases = [(f"J2 {label}", h) for label, h in rec.snaps]
    kinds = collections.Counter(label.startswith("last") for label, _ in rec.snaps)
    if kinds[False] < 3 or kinds[True] < 3 or len(rec.snaps) % 3:
        raise AssertionError(f"spd_inverse: J2 inputs {[label for label, _ in rec.snaps]}")
    for r in (4, 20, 32, 33, 64):
        q, _ = np.linalg.qr(gen.normal(size=(320, r, r)))
        top = np.geomspace(1.0, 1e4, 320)[:, None]
        h = np.einsum("bij,bj,bkj->bik", q, top ** np.linspace(0.0, 1.0, r)[None, :], q)
        h[::7] = np.eye(r)  # dead slots
        cases.append((f"random R={r}", torch.from_numpy(h.astype(np.float32)).to(dev)))
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
        (h,) = rec.first[(b, r)]
        flops = b * r * (1 + 2 * r + 4 * r * (r - 1))
        mix.append(dict(B=b, R=r, launches=n, path=inverse_path(b, r), **bound(flops, "fp32", 2 * 4 * b * r * r),
                        ms=cuda_ms(lambda: si.spd_inverse(h)),
                        graph_ms=graph_ms(lambda: si.spd_inverse(h)),
                        plain_ms=cuda_ms(lambda: si.spd_inverse_plain(h)),
                        library_ms=cuda_ms(lambda: torch.linalg.inv(h)), library_graph_ms=inv_ex_graph_ms(h)))
    for c in checks:
        print(f"spd_inverse {c['case']}: B={c['B']} R={c['R']} ({c['path']} path) cond <= {c['cond_max']:.3g}, "
              f"err/(cond*max) {c['ratio']:.3g}", flush=True)
    for m in mix:
        print(f"spd_inverse B={m['B']} R={m['R']} ({m['launches']} launches in J2, {m['path']} path): {m['ms']:.4f}ms "
              f"(graph {m['graph_ms']:.4f}), "
              f"plain {m['plain_ms']:.4f}ms, torch.linalg.inv {m['library_ms']:.4f}ms, "
              f"bound {m['bound_ms']:.2e}ms", flush=True)
    return dict(checks=checks, mix=mix, max_abs_err=worst)


# ------------------------------------------------------------ multi-device phase

# name: (dp, tp, the run's precision tiers); each against the one-process
# run of its tiers, within CROSS_TOL of those tiers. The "highest" runs (the
# fp32 kernel) hold the collectives where a fault would show; the bench
# tiers' bf16 roundings amplify a rank's other summation order (a rank runs
# half the slots and the kernels' plans depend on the batch; under tp each
# rank rounds its partial sum over its rows) to about 4e-3 (PERF.md).
MESH_RUNS = {"dp": (2, 1, BENCH_TIERS), "tp": (1, 2, BENCH_TIERS), "dp highest": (2, 1, {}),
             "tp highest": (1, 2, {})}
MESH_DEVICE = "cuda:0"
MESH_TIMEOUT = 300  # seconds a rank may take, start-up included


def j1_forced(**kw):
    """J1 at 10 forced iterations (the jackknife cross-check's depth)."""
    return jk_params(force_max_iter=True, max_iterations=10, **kw)


def mesh_rank(rank: int, world: int, store: str, job: str, out: str) -> None:
    """One rank of the multi-device phase (spawned; module docstring, 5c):
    joins the gloo group on ``store``, runs the phase's three runs, each
    from launch counts at 0 and no kept graphs, and writes what it got to
    ``out``.RANK."""
    import pickle

    import torch.distributed as dist

    from cp_cals_tpu_torch import cp_cals, jk_cp_cals, release_graphs
    from cp_cals_tpu_torch.parallel import distributed

    distributed.initialize(init_method="file://" + store, backend="gloo", rank=rank, world_size=world,
                           device=MESH_DEVICE)
    with open(job, "rb") as fh:
        kt5 = pickle.load(fh)
    x_np, rng = bench_tensor()
    queue = engine_queue(rng)
    # This process's first CUDA calls (library loads, cuBLAS), outside the walls.
    cp_cals(x_np, queue[::80], bench_params(**BENCH_TIERS, **pinned()),
            mesh=distributed.pod_mesh(1, device=MESH_DEVICE))
    runs = [(name, tp, lambda mesh, tp=tp, tiers=tiers: cp_cals(
        x_np, queue, bench_params(**tiers, **pinned()), mesh=mesh, shard_mode0=tp > 1))
        for name, (_, tp, tiers) in MESH_RUNS.items()]
    runs.append(("J1 dp", 1, lambda mesh: jk_cp_cals(x_np, [kt5], j1_forced(), mesh=mesh)))
    got = {}
    for name, tp, run in runs:
        mesh = distributed.pod_mesh(tp, device=MESH_DEVICE)
        release_graphs()
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        res = run(mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results, rep = (res.results[0], res.cals_report) if name.startswith("J1") else res
        got[name] = dict(results=results, report=rep, launches=read_counts(), collectives=dict(mesh.counts),
                         wall_s=wall)
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(got, fh)
    dist.destroy_process_group()


def spawn_ranks(world: int, kt5) -> list:
    """``world`` ranks of ``mesh_rank``, joined with a time limit; a rank's
    non-zero exit or time-out fails the phase. Returns each rank's runs."""
    import multiprocessing
    import pickle
    import shutil

    tmp = os.path.join("build", "chip_smoke_mesh")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    job, out, store = (os.path.abspath(os.path.join(tmp, n)) for n in ("job.pkl", "out", "store"))
    with open(job, "wb") as fh:
        pickle.dump(kt5, fh)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, world, store, job, out), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            raise AssertionError(f"multi-device phase: rank {r} exited {p.exitcode}")
    got = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as fh:
            got.append(pickle.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    return got


def recon_diff(a, b, drop_row: int | None = None, dev="cuda") -> float:
    """The relative difference of two 3-D models' dense reconstructions,
    |A - B| / |B|, in float64 on ``dev`` (mode-0 row ``drop_row``, a
    jackknife replicate's NaN row, left out of both)."""
    def dense(kt):
        fs = [torch.from_numpy(np.asarray(f, np.float64)).to(dev) for f in kt.factors]
        if drop_row is not None:
            fs[0] = torch.cat([fs[0][:drop_row], fs[0][drop_row + 1:]])
        return torch.einsum("ir,jr,kr,r->ijk", *fs, torch.from_numpy(np.asarray(kt.lam, np.float64)).to(dev))

    da, db = dense(a), dense(b)
    return (torch.linalg.vector_norm(da - db) / torch.linalg.vector_norm(db)).item()


def mesh_diff(label: str, got, want, dev="cuda", jk: bool = False, tol=None) -> dict:
    """A mesh run's (results, report) against the same run in one process:
    raises where the iteration counts, bucket-iterations or stats fetches
    (the chunks and eviction rounds) differ, or the results lie outside the
    tolerance: JK_CROSS_TOL for jackknife replicates (``jk``), else ``tol``
    (fit, reconstruction; None: recorded only). Returns the differences."""
    (res, rep), (res1, rep1) = got, want
    if [m.iters for m in rep.models] != [m.iters for m in rep1.models]:
        raise AssertionError(f"{label}: iteration counts differ from the single-process run")
    if dict(rep.engine_iterations) != dict(rep1.engine_iterations):
        raise AssertionError(f"{label}: bucket-iterations {rep.engine_iterations} vs {rep1.engine_iterations}")
    fetches = {r: c["stats_fetches"] for r, c in rep.loop_counts.items()}
    if fetches != {r: c["stats_fetches"] for r, c in rep1.loop_counts.items()}:
        raise AssertionError(f"{label}: stats fetches (chunks and eviction rounds) {fetches} differ")
    if jk:
        rec = max(recon_diff(a, b, f, dev) for f, (a, b) in enumerate(zip(res, res1)))
        lam = max(float(np.abs(a.lam - b.lam).max() / np.abs(b.lam).max()) for a, b in zip(res, res1))
        if not (rec <= JK_CROSS_TOL[0] and lam <= JK_CROSS_TOL[1]):
            raise AssertionError(f"{label}: replicates {rec:.3e} / {lam:.3e} from the single-process run")
        return dict(max_rel_recon_diff=rec, max_rel_lam_diff=lam)
    fit = max(abs(a.fit - b.fit) for a, b in zip(rep.models, rep1.models))
    rec = max(recon_diff(a, b, None, dev) for a, b in zip(res, res1))
    if tol is not None and not (fit <= tol[0] and rec <= tol[1]):
        raise AssertionError(f"{label}: fits {fit:.3e} / reconstructions {rec:.3e} from the single-process run")
    return dict(max_fit_diff=fit, max_rel_recon_diff=rec)


def mesh_phase(x_np, kt5, res_a, rep_a, run_a, res_b, rep_b, run_b) -> dict:
    """The multi-device phase (module docstring, 5c)."""
    from cp_cals_tpu_torch import jk_cp_cals

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    j1 = jk_cp_cals(x_np, [kt5], j1_forced())
    torch.cuda.synchronize()
    j1_wall = time.perf_counter() - t0
    single = {"dp": (res_b, rep_b, run_b["wall_s"]), "tp": (res_b, rep_b, run_b["wall_s"]),
              "dp highest": (res_a, rep_a, run_a["wall_s"]), "tp highest": (res_a, rep_a, run_a["wall_s"]),
              "J1 dp": (j1.results[0], j1.cals_report, j1_wall)}
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, kt5)
    phase_s = time.perf_counter() - t0
    out = dict(card=card_line(), phase_s=phase_s, runs={})
    for name, (want_res, want_rep, want_wall) in single.items():
        _, tp, tiers = MESH_RUNS.get(name, (2, 1, {"precision": "high"}))
        mttkrp = MTTKRP_KERNEL[tiers.get("mttkrp_precision") or tiers.get("precision", "highest")]
        rows = []
        for rank, got in enumerate(ranks):
            g = got[name]
            label = f"multi-device {name} rank {rank}"
            rep = g["report"]
            diff = mesh_diff(label, (g["results"], rep), (want_res, want_rep), jk=name.startswith("J1"),
                             tol=CROSS_TOL["highest" if tiers == {} else "bench-tiers"])
            steps = sum(rep.engine_iterations.values())
            # Every rank launches each kernel itself, the apply on every mode
            # (under tp on all of mode 0, gathered).
            check_counts(label, g["launches"], {mttkrp: 3 * steps, "normal_inverse": 3 * steps,
                                                "epilogue_apply": 3 * steps}, {})
            captures = sum(c["captures"] for c in rep.loop_counts.values())
            if (captures == 0) != (tp > 1):
                raise AssertionError(f"{label}: {captures} graph captures")
            c = g["collectives"]
            row = dict(rank=rank, wall_s=g["wall_s"], launches=g["launches"], captures=captures,
                       bucket_iterations=steps, collectives=c,
                       tp_per_bucket_iteration=c["tp"] / steps, tp_s_per_bucket_iteration=c["tp_s"] / steps,
                       host_per_bucket_iteration=c["host"] / steps, host_s_per_bucket_iteration=c["host_s"] / steps,
                       **diff)
            rows.append(row)
            print(f"{label}: wall {g['wall_s']:.3f}s (one process {want_wall:.3f}s), {steps} bucket-iterations, "
                  f"{captures} graph captures, launches {g['launches']}; collectives: {c['tp']} in the iteration "
                  f"({row['tp_per_bucket_iteration']:.2f} and {1e3 * row['tp_s_per_bucket_iteration']:.3f} ms per "
                  f"bucket-iteration), {c['host']} in the host loop ({row['host_per_bucket_iteration']:.2f} and "
                  f"{1e3 * row['host_s_per_bucket_iteration']:.3f} ms per bucket-iteration); against one process "
                  f"{diff}", flush=True)
        out["runs"][name] = dict(single_wall_s=want_wall, ranks=rows)
    print(f"multi-device phase: {phase_s:.1f}s for two ranks on {MESH_DEVICE} over gloo ({out['card']})",
          flush=True)
    return out


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
        shapes.append(dict(shape=shape, **bound(n, "fp32", 8 * n),
                           ms=cuda_ms(lambda: probe.probe_copy(x)),
                           graph_ms=graph_ms(lambda: probe.probe_copy(x)),
                           plain_ms=cuda_ms(lambda: probe.probe_copy_plain(x)),
                           library_ms=cuda_ms(lambda: torch.mul(x, 0.999)),
                           library_graph_ms=graph_ms(lambda: torch.mul(x, 0.999))))
        m = shapes[-1]
        print(f"probe_copy {shape}: exact; {m['ms']:.4f}ms (graph {m['graph_ms']:.4f}), plain {m['plain_ms']:.4f}ms, "
              f"torch.mul {m['library_ms']:.4f}ms (graph {m['library_graph_ms']:.4f}), bound {m['bound_ms']:.4f}ms",
              flush=True)
    return dict(result=res, launches=counts["probe_copy"], shapes=shapes)


# ------------------------------------------------------------ N-D phase


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profiled(fn) -> dict:
    """``fn`` once under torch.profiler: its wall, the device's busy time
    (the union of the CUDA kernels' intervals) and share of the wall, and
    the device time of the largest kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name and "Memset" not in e.name:
            d, start = e.time_range.elapsed_us(), e.time_range.start
            intervals.append((start, start + d))
            by_name[e.name] += d
    busy = union_us(intervals) / 1e3
    return dict(wall_s=wall, busy_ms=busy, busy_share=busy / 1e3 / wall, kernels=len(intervals),
                kernel_ms={n[:100]: us / 1e3 for n, us in by_name.most_common(15)})


class GramsRecorder(Recorder):
    """The iteration's calls of the normal inverse or the apply by (B, K):
    K the other-mode gramians the call multiplies (for the apply, those of
    the FastALS error it finishes; 0 without). Counts only."""

    module, keep, n_first = "cp_cals_tpu_torch.solvers.iteration", (), 0


class HinvRecorder(GramsRecorder):
    attr = "normal_inverse"

    def key(self, grams, rank_mask, skip):
        return (rank_mask.shape[0], len(grams) - 1)


class ApplyRecorder(GramsRecorder):
    attr = "epilogue_apply"

    def key(self, g, hinv, iters, jk_fiber, zero_jk=False, err_inputs=None):
        return (g.shape[0], 0 if err_inputs is None else len(err_inputs) - 1)


class HinvMixRecorder(Recorder):
    """The iteration's normal-inverse calls on a 3-D run by (B, R, mode),
    each key's first eager inputs copied (the gramians, rank mask, mode)."""

    module, attr = "cp_cals_tpu_torch.solvers.iteration", "normal_inverse"

    def key(self, grams, rank_mask, skip):
        return (rank_mask.shape[0], rank_mask.shape[1], skip)


class ApplyMixRecorder(Recorder):
    """The same for the apply, by (B, R, mode, JK zero), its six inputs."""

    module, attr, n_first = "cp_cals_tpu_torch.solvers.iteration", "epilogue_apply", 6

    def key(self, g, hinv, iters, jk_fiber, zero_jk=False, err_inputs=None):
        return (g.shape[0], g.shape[2], MODES.index(g.shape[1]), bool(zero_jk))


def hinv_mix(rec, label: str) -> list:
    """The normal inverse at every (B, R, mode) of a recorded run, on that
    run's own normal matrices: held against its plain version at
    TOL["hinv"] (per model, over cond(H) max|H^-1|) and timed, with
    torch.linalg.inv beside it."""
    from cp_cals_tpu_torch.ops import fused_epilogue as fe
    from cp_cals_tpu_torch.ops.gramians import hadamard_but_one
    from cp_cals_tpu_torch.ops.update import padded_hadamard

    mix = []
    for (b, r, mode), n in sorted(rec.shapes.items(), reverse=True):
        grams, mask, skip = rec.first[(b, r, mode)]
        got, want = fe.normal_inverse(grams, mask, skip), fe.normal_inverse_plain(grams, mask, skip)
        h = padded_hadamard(hadamard_but_one(grams, skip), mask)
        reading = hinv_reading(got, want, h)
        if not reading["ratio"] <= TOL["hinv"]:
            raise AssertionError(f"normal_inverse B={b} R={r} mode={mode} ({label}'s recorded inputs): {reading}")
        mix.append(dict(
            B=b, R=r, mode=mode, launches=n, path=inverse_path(b, r), **reading,
            **bound(b * (4 * r**3 + 5 * r * r), "fp32", 4 * 3 * b * r * r + b * r),
            ms=cuda_ms(lambda: fe.normal_inverse(grams, mask, skip)),
            graph_ms=graph_ms(lambda: fe.normal_inverse(grams, mask, skip)),
            plain_ms=cuda_ms(lambda: fe.normal_inverse_plain(grams, mask, skip)),
            library_ms=cuda_ms(lambda: torch.linalg.inv(h)),
        ))
    m = max(mix, key=lambda m: m["ratio"])
    print(f"normal_inverse {label} mix: {len(mix)} shapes, {sum(m['launches'] for m in mix)} launches, largest "
          f"err/(cond*max) {m['ratio']:.3g} (B={m['B']} R={m['R']} mode={m['mode']}, cond {m['cond_max']:.3g})",
          flush=True)
    return mix


def apply_mix(rec, label: str) -> list:
    """The apply at every (B, R, mode, JK zero) of a recorded run, on that
    run's own inputs: F, lam and the gramian held against the plain
    version at TOL["apply"], the FastALS error's square at
    TOL["apply_err_sq"] of |X|^2 (module docstring of TOL), and timed."""
    from cp_cals_tpu_torch.ops import fused_epilogue as fe

    mix = []
    for (b, r, mode, zero_jk), n in sorted(rec.shapes.items(), reverse=True):
        g, hinv, iters, jk, zero_jk, err_inputs = rec.first[(b, r, mode, zero_jk)]
        got = fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)
        want = fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk, err_inputs)
        torch.cuda.synchronize()
        err = 0.0
        for a, w in zip(got[:3], want[:3]):
            e, scale = rel_err(a, w)
            if not e <= TOL["apply"] * max(scale, 1e-30):
                raise AssertionError(f"epilogue_apply B={b} R={r} mode={mode} zero_jk={zero_jk} "
                                     f"({label}'s recorded inputs): {e} vs {scale}")
            err = max(err, e)
        with_err = err_inputs is not None
        err_sq = None
        if with_err:
            xn2 = err_inputs[0].double() ** 2
            err_sq = ((got[3].double() ** 2 - want[3].double() ** 2).abs() / xn2.clamp(min=1e-300)).max().item()
            if not err_sq <= TOL["apply_err_sq"]:
                raise AssertionError(f"epilogue_apply error B={b} R={r} mode={mode} ({label}'s recorded inputs): "
                                     f"squared error differs by {err_sq} of |X|^2")
        i = MODES[mode]
        flops = b * (4 * i * r * r + i * r + (12 * i * r + 20 * r * r if with_err else 0))
        nbytes = 4 * (2 * b * i * r + 2 * b * r * r + b * r + 2 * b) + (4 * (2 * b * r * r + 2 * b) if with_err else 0)
        mix.append(dict(
            B=b, R=r, mode=mode, zero_jk=zero_jk, with_err=with_err, launches=n, max_abs_err=err,
            err_sq_rel=err_sq, **bound(flops, "fp32", nbytes),
            ms=cuda_ms(lambda: fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)),
            graph_ms=graph_ms(lambda: fe.epilogue_apply(g, hinv, iters, jk, zero_jk, err_inputs)),
            plain_ms=cuda_ms(lambda: fe.epilogue_apply_plain(g, hinv, iters, jk, zero_jk, err_inputs)),
            library_ms=None,
        ))
    sq = [m["err_sq_rel"] for m in mix if m["with_err"]]
    print(f"epilogue_apply {label} mix: {len(mix)} shapes, {sum(m['launches'] for m in mix)} launches, largest "
          f"|difference| {max(m['max_abs_err'] for m in mix):.3g}, squared error {max(sq):.3g} of |X|^2",
          flush=True)
    return mix


def mix_summary(mix) -> dict:
    """A launch mix's launches, largest difference from the plain version,
    and per-launch means weighted by launches (None where a shape has no
    reading)."""
    n = sum(m["launches"] for m in mix)
    out = dict(launches=n, shapes=len(mix), max_abs_err=max(m["max_abs_err"] for m in mix))
    for f in ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [m[f] for m in mix]
        out[f] = None if any(v is None for v in vals) else sum(m["launches"] * v for m, v in zip(mix, vals)) / n
    return out


def by_k(rec) -> dict:
    out = collections.Counter()
    for (_, k), n in rec.shapes.items():
        out[k] += n
    return dict(out)


def dense(kt, dtype=np.float64) -> np.ndarray:
    """The full tensor of a host Ktensor of any order."""
    idx = "ijklm"[: len(kt.factors)]
    expr = ",".join(c + "r" for c in idx) + ",r->" + idx
    return np.einsum(expr, *(f.astype(dtype) for f in kt.factors), kt.lam.astype(dtype))


def nd_phase(dev) -> dict:
    """The bench workload with a fourth mode at full width: 400 models, 10
    forced iterations, at "highest" and at the bench tiers, through the
    graph loop, under AUTO: every mode takes the table's pick for its
    bucket and tier, the twostep or krp_gemm (the fused gate refuses N-D),
    and every epilogue the fused kernels with K = 3 other gramians (four
    normal inverses, all K = 3, and four applies, one with the K = 3 error,
    per bucket-iteration). Then one model per bucket against the port's
    float64 CPU run with the card's picks, the bench-tier run profiled for
    the device's busy share, and each bucket's picked MTTKRP timed at every
    (B, mode) of the run for its share of the device time."""
    from cp_cals_tpu_torch import cp_cals
    from cp_cals_tpu_torch.ops import mttkrp as mt

    x_np, rng = bench_tensor(MODES4)
    queue = engine_queue(rng, MODES4)
    per_step, routes = fused("highest", n_modes=4, mttkrp_modes=0), {"twostep": 4}
    engine_run(x_np, queue[::80], BENCH_TIERS, "4-D warm-up", check_fit=False, per_step=per_step, routes=routes,
               **pinned())
    out, results, picks = {}, {}, {}
    for name, tiers in (("4-D highest", {}), ("4-D bench-tiers", BENCH_TIERS)):
        with HinvRecorder() as hrec, ApplyRecorder() as arec:
            # The bench tiers' reported fit is the FastALS error of a bf16
            # MTTKRP, whose noise the 4-D tensor's fits do not survive; the
            # cross-check below holds the models' dense fits instead.
            res, rep, run = engine_run(x_np, queue, tiers, name, check_fit=not tiers)
        hrec.check_total(f"{name} normal inverses", run["launches"]["normal_inverse"])
        arec.check_total(f"{name} applies", run["launches"]["epilogue_apply"])
        steps = sum(rep.engine_iterations.values())
        if by_k(hrec) != {3: 4 * steps} or by_k(arec) != {0: 3 * steps, 3: steps}:
            raise AssertionError(f"{name}: normal inverses by K {by_k(hrec)}, applies by K {by_k(arec)}")
        run.update(normal_inverse_by_k=by_k(hrec), apply_by_k=by_k(arec))
        out[name], results[name] = run, (res, rep)
        picks[name] = {int(r): tuple(m) for r, (m, _) in run["picks"].items()}
    out["cross_check"] = nd_cross_check(x_np, queue, results, picks)
    x = torch.from_numpy(x_np).to(dev)
    params = bench_params(**BENCH_TIERS)
    prof = profiled(lambda: cp_cals(x_np, queue, params))
    # Each bucket's picked MTTKRP alone at every (B, R) and mode of the runs,
    # at each run's MTTKRP tier, on its held layout.
    alloc = engine_batches([kt.rank for kt in queue], BUCKETS, BUFFER)
    gen = torch.Generator().manual_seed(21)
    mix, held = [], {}
    for r, b in sorted(alloc.items()):
        factors = [torch.rand(b, m, r, generator=gen).to(dev) for m in MODES4]
        for mode in range(4):
            row = dict(B=b, R=r, mode=mode)
            for tier, name in (("default", "4-D bench-tiers"), ("highest", "4-D highest")):
                m = picks[name][r][mode]
                if (mode, m) not in held:
                    held[(mode, m)] = mt.prepare_mode(x, mode, m)
                row[tier] = graph_ms(lambda: mt.mttkrp_batched(x, factors, mode, m, tier, held[(mode, m)]))
                row[f"{tier}_method"] = m
            mix.append(row)
    w = results["4-D bench-tiers"][1].engine_iterations
    mttkrp_ms = sum(w.get(m["R"], 0) * m["default"] for m in mix)
    prof.update(mttkrp_ms=mttkrp_ms, mttkrp_share=mttkrp_ms / prof["busy_ms"])
    out.update(profile=prof, mttkrp_mix=mix)
    print(f"4-D bench-tiers profiled: wall {prof['wall_s']:.3f}s, device busy {prof['busy_ms']:.2f} ms = "
          f"{prof['busy_share']:.3f} of the wall, {prof['kernels']} kernels; the picked MTTKRPs alone "
          f"{mttkrp_ms:.2f} ms = {prof['mttkrp_share']:.3f} of the busy time", flush=True)
    for n, ms in prof["kernel_ms"].items():
        print(f"  {ms:9.3f} ms  {n}", flush=True)
    for m in mix:
        print(f"MTTKRP 4-D B={m['B']} R={m['R']} mode={m['mode']}: default {m['default_method']} {m['default']:.4f}ms, "
              f"highest {m['highest_method']} {m['highest']:.4f}ms (graph-replayed)", flush=True)
    return out


def nd_cross_check(x_np, queue, runs: dict, picks: dict) -> dict:
    """One model per bucket (ranks 4, 8, 12, 16, 20) of each 4-D run
    against the port's float64 CPU run of the same settings from the same
    inits, each bucket with the card run's picks (``card_picks``): the
    relative reconstruction difference and the difference of the fits from
    the dense reconstructions (the bench tiers' reported fit is the fast
    tier's), held to ND_CROSS_TOL on the ranks ND_HELD_RANKS names,
    reported for all. The port's float32 CPU run at "highest" is measured
    the same way beside them: what float32 rounding alone moves."""
    from cp_cals_tpu_torch import Ktensor, cp_cals

    pick = [20 * (r - 1) for r in BUCKETS]
    q64 = [Ktensor(tuple(f.astype(np.float64) for f in queue[i].factors), queue[i].lam.astype(np.float64))
           for i in pick]
    x64 = x_np.astype(np.float64)
    xn = np.linalg.norm(x64)

    def dense_fit(kt):
        d = dense(kt)
        return d, 1 - np.linalg.norm(x64 - d) / xn

    def diffs(results, reference, index):
        out = []
        for n, i in enumerate(index):
            (d, f), (d_ref, f_ref) = dense_fit(results[i]), reference[n]
            out.append(dict(rank=BUCKETS[n], rel_recon=float(np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref)),
                            dense_fit=float(abs(f - f_ref)), fit=float(f), reference_fit=float(f_ref)))
        return out

    out, refs = dict(cpu_s={}), {}
    for name, tiers in (("highest", {}), ("bench-tiers", BENCH_TIERS)):
        t0 = time.perf_counter()
        with card_picks({r: (m, None) for r, m in picks["4-D " + name].items()}):
            res64, _ = cp_cals(x64, q64, bench_params(mode_layouts="materialized", **tiers), device="cpu")
        out["cpu_s"][name] = time.perf_counter() - t0
        refs[name] = [dense_fit(k) for k in res64]
    with card_picks({r: (m, None) for r, m in picks["4-D highest"].items()}):
        res32, _ = cp_cals(x_np, [queue[i] for i in pick], bench_params(mode_layouts="materialized"), device="cpu")
    out["cpu_float32"] = diffs(res32, refs["highest"], range(len(pick)))
    print("cross-check 4-D: the port's float32 CPU run vs its float64 run at 'highest', by rank (fit/recon): "
          + ", ".join(f"R={d['rank']} {d['dense_fit']:.2e}/{d['rel_recon']:.2e}" for d in out["cpu_float32"]),
          flush=True)
    for name, (results, rep) in runs.items():
        per = diffs(results, refs[name.removeprefix("4-D ")], pick)
        held = [d for d in per if d["rank"] in ND_HELD_RANKS[name]]
        fit, rec = max(d["dense_fit"] for d in held), max(d["rel_recon"] for d in held)
        fit_tol, rec_tol = ND_CROSS_TOL[name]
        print(f"cross-check {name} vs CPU float64 (5 models, {out['cpu_s']}s on the CPU): held ranks "
              f"{ND_HELD_RANKS[name]}: max |dense fit diff| {fit:.3e}, max relative reconstruction diff {rec:.3e}; "
              "by rank (fit, reference fit, fit diff/recon diff) "
              + ", ".join(f"R={d['rank']} {d['fit']:.4f} {d['reference_fit']:.4f} {d['dense_fit']:.2e}/"
                          f"{d['rel_recon']:.2e}" for d in per), flush=True)
        if not (fit <= fit_tol and rec <= rec_tol):
            raise AssertionError(f"cross-check of {name} against the CPU float64 run failed")
        out[name] = dict(max_dense_fit_diff=fit, max_rel_recon_diff=rec, by_rank=per)
    return out


def widened_phase(dev) -> dict:
    """The normal inverse and the apply with K = 3 and 4 other gramians, at
    every (B, R) the engine allocates and every mode of ``WIDE[K]``, held
    against their plain versions on the card as the K = 2 kernel phase
    holds them (random normalized factors with masked columns and a dead
    slot; the inverse per live model at TOL["hinv"] * cond(H) * max|H^-1|,
    where 2I - H must fail), and timed: the apply as the iteration calls it, with the error
    on the last mode. K = 2 keeps the kernel phase's checks."""
    from cp_cals_tpu_torch.ops import fused_epilogue as fe
    from cp_cals_tpu_torch.ops.gramians import gramians, hadamard_but_one
    from cp_cals_tpu_torch.ops.update import padded_hadamard
    from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches

    (alloc,) = allocate_bucket_batches({r: 80 for r in BUCKETS}, BUFFER)
    gen = torch.Generator().manual_seed(29)
    rows, worst = {}, {"hinv": 0.0, "apply": 0.0, "apply_err": 0.0}
    for k, modes in WIDE.items():
        rows[k] = []
        n = len(modes)
        for r, b in sorted(alloc.items()):
            true = torch.tensor([max(1, r - (s % 4)) for s in range(b)])
            true[-1] = 0
            mask = (torch.arange(r)[None, :] < true[:, None]).to(dev)
            # Uniform [0, 1) factors: their columns correlate, so the
            # product of K gramians is far from the identity (cond up to
            # ~1e2), and the first-order inverse 2I - H fails the check.
            factors = []
            for m in modes:
                f = torch.rand(b, m, r, generator=gen).to(dev) * mask[:, None, :]
                factors.append((f / torch.clamp(torch.linalg.vector_norm(f, dim=1, keepdim=True), min=1e-30)))
            grams = gramians(factors)
            jk = torch.full((b,), -1, dtype=torch.int32, device=dev)
            iters = torch.full((b,), 4, dtype=torch.int32, device=dev)
            for mode in range(n):
                got = fe.normal_inverse(grams, mask, mode)
                want = fe.normal_inverse_plain(grams, mask, mode)
                h = padded_hadamard(hadamard_but_one(grams, mode), mask)
                live = mask.any(1)
                reading = hinv_reading(got[live], want[live], h[live])
                eye = torch.eye(r, device=dev).expand_as(h)
                if not reading["ratio"] <= TOL["hinv"] or hinv_reading(
                        (2 * eye - h)[live], want[live], h[live])["ratio"] <= TOL["hinv"]:
                    raise AssertionError(f"normal_inverse K={k} B={b} R={r} mode={mode}: {reading}")
                i = modes[mode]
                g = torch.rand(b, i, r, generator=gen).to(dev) * mask[:, None, :]
                with_err = mode == n - 1
                x_norm = cancelling_norms(g, got, iters, jk, False, grams[:-1]) if with_err else None
                err_inputs = (x_norm, *grams[:-1]) if with_err else None
                a_got = fe.epilogue_apply(g, got, iters, jk, False, err_inputs)
                a_want = fe.epilogue_apply_plain(g, got, iters, jk, False, err_inputs)
                torch.cuda.synchronize()
                errs = [rel_err(a, w_) for a, w_ in zip(a_got[:3], a_want[:3])]
                if any(not e <= TOL["apply"] * max(sc, 1e-30) for e, sc in errs):
                    raise AssertionError(f"epilogue_apply K={k} B={b} R={r} mode={mode}: {errs}")
                e_rel = 0.0
                if with_err:
                    e_rel = ((a_got[3].double() - a_want[3].double()).abs()
                             / a_want[3].double().abs().clamp(min=1e-30)).max().item()
                    if not e_rel <= TOL["apply_err"]:
                        raise AssertionError(f"epilogue_apply error K={k} B={b} R={r}: relative {e_rel}")
                worst["hinv"] = max(worst["hinv"], reading["max_abs_err"])
                worst["apply"] = max(worst["apply"], max(e for e, _ in errs))
                worst["apply_err"] = max(worst["apply_err"], e_rel)
                a_flops = b * (4 * i * r * r + i * r + (12 * i * r + (18 + k) * r * r if with_err else 0))
                a_bytes = (4 * (2 * b * i * r + 2 * b * r * r + b * r + 2 * b)
                           + (4 * (k * b * r * r + 2 * b) if with_err else 0))
                rows[k].append(dict(
                    K=k, B=b, R=r, mode=mode, I=i, with_err=with_err, path=inverse_path(b, r),
                    hinv=dict(**bound(b * (4 * r**3 + (k + 3) * r * r), "fp32", 4 * (k + 1) * b * r * r + b * r),
                              max_abs_err=reading["max_abs_err"], ratio=reading["ratio"],
                              ms=cuda_ms(lambda: fe.normal_inverse(grams, mask, mode)),
                              graph_ms=graph_ms(lambda: fe.normal_inverse(grams, mask, mode)),
                              plain_ms=cuda_ms(lambda: fe.normal_inverse_plain(grams, mask, mode)),
                              library_ms=cuda_ms(lambda: torch.linalg.inv(h)), library_graph_ms=inv_ex_graph_ms(h)),
                    apply=dict(**bound(a_flops, "fp32", a_bytes), max_abs_err=max(e for e, _ in errs),
                               max_err_rel=e_rel,
                               ms=cuda_ms(lambda: fe.epilogue_apply(g, got, iters, jk, False, err_inputs)),
                               graph_ms=graph_ms(lambda: fe.epilogue_apply(g, got, iters, jk, False, err_inputs)),
                               plain_ms=cuda_ms(lambda: fe.epilogue_apply_plain(g, got, iters, jk, False, err_inputs)),
                               library_ms=None, library_graph_ms=None),
                ))
                row = rows[k][-1]
                print(f"widened K={k} B={b:3d} R={r:2d} mode={mode}: hinv {row['hinv']['ms']:.4f}ms (graph "
                      f"{row['hinv']['graph_ms']:.4f}, err/(cond*max) {reading['ratio']:.3g}), apply "
                      f"{row['apply']['ms']:.4f}ms (graph {row['apply']['graph_ms']:.4f}, error {with_err})",
                      flush=True)
    return dict(rows=rows, worst=worst)


def f64_phase() -> dict:
    """A small float64 problem on the card: the gates send every mode to
    the twostep and every epilogue to the unfused path (no kernel launches),
    held to the port's float64 CPU run of the same settings."""
    from cp_cals_tpu_torch import CalsParams, cp_cals, launches, random_ktensor_host

    rng = np.random.default_rng(31)
    modes = (30, 25, 20)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    x = dense(kt) + 1e-3 * rng.standard_normal(modes)
    queue = [random_ktensor_host(rng, modes, r, dtype=np.float64) for r in (1, 2, 3, 4, 5, 6)]
    params = CalsParams(max_iterations=10, force_max_iter=True, bucket_ranks=(2, 4, 8), buffer_size=24, **pinned())
    torch.cuda.synchronize()
    reset_counts()
    res_d, rep_d = cp_cals(x, queue, params)
    counts, routes = read_counts(), launches.routes()
    steps = sum(rep_d.engine_iterations.values())
    check_launches("float64 on the card", counts, {}, steps)
    check_routes("float64 on the card", routes, {"twostep": 3}, steps)
    res_c, rep_c = cp_cals(x, queue, params, device="cpu")
    fit = max(abs(a.fit - b.fit) for a, b in zip(rep_d.models, rep_c.models))
    rec = max(float(np.linalg.norm(dense(a) - dense(b)) / np.linalg.norm(dense(b))) for a, b in zip(res_d, res_c))
    print(f"float64 on the card ({steps} bucket-iterations, routes {routes}, no kernel launched) vs the CPU: "
          f"max |fit diff| {fit:.3e}, max relative reconstruction diff {rec:.3e}", flush=True)
    if not (fit <= F64_TOL[0] and rec <= F64_TOL[1]):
        raise AssertionError("float64 on the card differs from the CPU run")
    return dict(max_fit_diff=fit, max_rel_recon_diff=rec, routes=routes, bucket_iterations=steps)


def mttkrp_methods_row(x, mode, u_factors) -> dict:
    """The port's twostep and krp_gemm at one bucket's shapes and mode,
    each on its held layout, graph-replayed (and eager), at "highest" and
    the bench's MTTKRP tier."""
    from cp_cals_tpu_torch.ops import mttkrp as mt

    out = {}
    for method, fn in (("twostep", mt.mttkrp_batched_twostep), ("krp_gemm", mt.mttkrp_batched_krp)):
        held = mt.prepare_batched(x, [method] * 3)[mode]
        for tier in ("highest", "default"):
            out[f"{method} {tier}"] = dict(ms=cuda_ms(lambda: fn(x, u_factors, mode, tier, held)),
                                           graph_ms=graph_ms(lambda: fn(x, u_factors, mode, tier, held)))
    return out


# ------------------------------------------------------------ NNLS, line search and debug phases

# NNLS at full width: the JAX package's NNLS experiment without --quick
# (cp_cals_tpu/experiments.py:442-483): a non-negative 100x100x100 target,
# the absolute values of a seeded rank-5 Ktensor (drawn with NumPy: JAX's
# threefry draw is not reproducible here), 100 models of ranks 1-10 x 10,
# buckets 4/8/12, 50 forced iterations at "high", block principal pivoting.
NN_MODES, NN_RANK, NN_ITERS, NN_SEED = (100, 100, 100), 5, 50, 1
NN_BUCKETS = (4, 8, 12)
# CALS against each model's ALS (cp_batched_als per rank: each model's
# cp_als trajectory) on the card, every model's |fit difference| <=
# NN_FIT_TOL. The JAX experiment's check (experiments.py:compare_als_cals,
# |e_cals - e_als| <= 1e-1 * max(1, |e_als|)) is reported beside it and not
# held: the target is exactly rank 5, so some models of rank 10 fit it to
# the FastALS error's float32 floor (err^2 is a difference of terms of
# |X|^2 = 4.95e5, carried through an MTTKRP rounded at about 2^-16, so
# err is noise below about 2.7), where their errors read 0 to 1.7 and the
# two packings of the MTTKRP (B*R columns of padded buckets against
# batches of one rank) send them along different paths: on an H100 up to
# 0.41 apart (a fit difference of 5.8e-4). The NN_F64_WORST models
# furthest apart on the card are run again on the CPU, CALS and ALS, in
# float32 at "high" (the same packings and tier rule: a gap of the same
# order, 0.41 on the same model) and in float64, where CALS and ALS must
# agree to NN_F64_TOL (the JAX check's relative form; it read 0).
NN_FIT_TOL, NN_F64_WORST, NN_F64_TOL = 1e-3, 5, 1e-9
# Fits of NN_HELD models (one per rank) against the port's float64 CPU run
# at "highest" from the same inits: |fit difference| <= NN_HELD_TOL (read
# 4.1e-5 on an H100).
NN_HELD, NN_HELD_TOL = [10 * (r - 1) for r in range(1, 11)], 2e-4
# Lawson-Hanson and BPP on the rank-8 bucket (ranks 5-8, 40 models) on the
# card, each against the port's float64 CPU runs of that bucket, where the
# two algorithms must agree to NN_LH_F64_AGREE (they read 0). In float32
# Lawson-Hanson leaves rows unconverged at its trip bounds (1.7 % of the
# bucket's row updates, 0 for BPP; on such normal matrices JAX's own
# float32 solver leaves the same rows: tests/test_torch_nnls.py), so its
# models of rank 7-8 part: the port's float32 CPU run reads 8.0e-3 against
# float64 for Lawson-Hanson and 6.7e-4 for BPP (tools/nnls_witness.py),
# and the card read 8.2e-3 between the two algorithms. NN_LH_F64_TOL
# holds each.
NN_LH_BUCKET, NN_LH_F64_AGREE = 8, 1e-12
NN_LH_F64_TOL = {"lawson_hanson": 1.5e-2, "bpp": 2e-3}
# Line search at full width: the bench workload at "highest", 20 forced
# iterations, interval 5, both methods; 20 models against the port's
# float64 CPU run of the same settings (CROSS_TOL["highest"]).
LS_ITERS, LS_INTERVAL = 20, 5
# NO_ERROR_CHECKING is held to the "highest" run's limits (it read 1.4e-6
# / 3.9e-5 on an H100). ERROR_CHECKING's reconstruction looser: a
# candidate whose exact error is within float32 rounding of the current
# one is accepted in one run and not in the other, and the two models then
# part along a direction the fit barely sees (read 4.3e-6 / 6.0e-4).
LS_CROSS_TOL = {"no_error_checking": CROSS_TOL["highest"], "error_checking": (5e-5, 2e-3)}
LS_METHODS = ("no_error_checking", "error_checking")
# The debug run: a small problem whose models' weights are scaled by 1.05
# at their 6th iteration (an injected rise of the error) through the
# unfused path with NEC line search, 8 forced iterations; the card's
# entries against the same float32 run on the CPU: the same (iteration,
# model) entries in order, errors at 1e-4 relative. (Run on, both runs
# also record rises of 1e-4 at the float32 FastALS error's noise floor from
# the 10th iteration on, different ones on the card and the CPU.)
DEBUG_TOL, DEBUG_ITERS = 1e-4, 8


def nn_problem():
    from cp_cals_tpu_torch import Ktensor, random_ktensor_host
    from cp_cals_tpu_torch.ktensor import to_tensor

    rng = np.random.default_rng(NN_SEED)
    kt = random_ktensor_host(rng, NN_MODES, NN_RANK, dtype=np.float32)
    kt = Ktensor(tuple(torch.from_numpy(np.abs(f)) for f in kt.factors), torch.from_numpy(np.abs(kt.lam)))
    x = to_tensor(kt).numpy().astype(np.float32)
    queue = [random_ktensor_host(rng, NN_MODES, r, dtype=np.float32) for r in range(1, 11) for _ in range(10)]
    return x, queue


def nn_params(**kw):
    from cp_cals_tpu_torch import CalsParams, UpdateMethod

    base = dict(max_iterations=NN_ITERS, force_max_iter=True, update_method=UpdateMethod.NNLS,
                bucket_ranks=NN_BUCKETS, precision="high")
    return CalsParams(**{**base, **kw})


def nn_engine_run(name, x, queue, **kw) -> tuple:
    """One NNLS cp_cals run on the card from counts at 0: no epilogue
    kernel; pinned, the tensor-core MTTKRP three times per bucket-iteration,
    and under AUTO as its buckets' picks say (``check_table_run``); every
    factor entry >= 0 exactly."""
    from cp_cals_tpu_torch import cp_cals, launches
    from cp_cals_tpu_torch.utils import lut

    params = nn_params(**kw)
    torch.cuda.synchronize()
    reset_counts()
    lut.reset_lookup_stats()
    t0 = time.perf_counter()
    res, rep = cp_cals(x, queue, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = read_counts(), launches.routes()
    steps = sum(rep.engine_iterations.values())
    table = {}
    if params.mttkrp_method.value == "auto":
        table = check_table_run(name, x.shape, [kt.rank for kt in queue], params, rep, counts, routes,
                                epilogue=False)
    else:
        check_launches(name, counts, {"fused_mttkrp_tc": 3}, steps)
        check_routes(name, routes, {"fused": 3}, steps)
    min_entry = min(float(f.min()) for kt in res for f in kt.factors)
    if not min_entry >= 0.0 or any(not np.isfinite(f).all() for kt in res for f in kt.factors):
        raise AssertionError(f"{name}: a factor entry is negative or not finite ({min_entry})")
    fits = np.array([m.fit for m in rep.models])
    out = dict(wall_s=wall, models_per_s=len(queue) / wall, mean_fit=float(fits.mean()), min_factor_entry=min_entry,
               bucket_iterations=rep.engine_iterations, launches=counts, routes=routes, loop=loop_totals(rep), **table)
    print(f"NNLS {name}: wall {wall:.3f}s, {out['models_per_s']:.1f} models/s, mean fit {out['mean_fit']:.6f}, "
          f"min factor entry {min_entry}, bucket-iterations {steps}, launches {counts}, MTTKRP routes {routes}, "
          f"loop {out['loop']}", flush=True)
    return res, rep, out


def nnls_update_times(x, res, queue) -> dict:
    """The NNLS update's device time per bucket-iteration (three modes),
    both algorithms, at each bucket's (B, R) on the engine's own normal
    matrices and MTTKRPs of its fitted models: the update replayed from a
    CUDA graph (a captured update runs every loop to its bound, so the time
    does not depend on the data), and eager."""
    from cp_cals_tpu_torch.ops.gramians import gramians, hadamard_but_one
    from cp_cals_tpu_torch.ops.mttkrp import mttkrp_batched
    from cp_cals_tpu_torch.ops.update import padded_hadamard, update_factor_nnls
    from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches, bucket_rank

    dev = torch.device("cuda")
    xt = torch.from_numpy(x).to(dev)
    demands = collections.Counter(bucket_rank(kt.rank, NN_BUCKETS) for kt in queue)
    (wave,) = allocate_bucket_batches(dict(demands), nn_params().buffer_size)
    out = {}
    for r, b in sorted(wave.items()):
        models = [kt for kt in res if bucket_rank(kt.rank, NN_BUCKETS) == r][:b]
        fs = [torch.zeros((b, m, r), device=dev) for m in NN_MODES]
        mask = torch.zeros((b, r), dtype=torch.bool, device=dev)
        for s, kt in enumerate(models):
            for f, src in zip(fs, kt.factors):
                f[s, :, :kt.rank] = torch.from_numpy(src).to(dev)
            mask[s, :kt.rank] = True
        grams = gramians(fs)
        row = dict(B=b, R=r)
        for alg in ("bpp", "lawson_hanson"):
            per_mode = []
            for n in range(3):
                g = mttkrp_batched(xt, fs, n, "twostep", "high")
                h = padded_hadamard(hadamard_but_one(grams, n), mask)
                warm = torch.ones(g.shape, dtype=torch.bool, device=dev)
                per_mode.append((lambda g=g, h=h, w=warm: update_factor_nnls(g, h, w, 0, alg)))
            row[f"{alg}_graph_ms"] = sum(graph_ms(fn, reps=1, replays=3) for fn in per_mode)
            row[f"{alg}_ms"] = sum(cuda_ms(fn, reps=1, warm=1) for fn in per_mode)
        out[r] = row
        print(f"NNLS update per bucket-iteration B={b} R={r}: BPP {row['bpp_graph_ms']:.3f}ms replayed "
              f"({row['bpp_ms']:.3f} eager), Lawson-Hanson {row['lawson_hanson_graph_ms']:.3f}ms replayed "
              f"({row['lawson_hanson_ms']:.3f} eager)", flush=True)
    return out


def nnls_phase() -> dict:
    """NNLS at the JAX experiment's full size (module docstring, 4c)."""
    from cp_cals_tpu_torch import AlsParams, Ktensor, UpdateMethod, cp_batched_als, cp_cals
    from cp_cals_tpu_torch.solvers.cals import bucket_rank

    x, queue = nn_problem()
    nn_engine_run("warm-up", x, queue[::10], **pinned())
    # The run's MTTKRP calls, replays included: the tensor-core kernel held
    # and timed at each (B, R, mode) of its launch mix.
    with CubeMttkrpRecorder() as mix_rec:
        res, rep, run = nn_engine_run("BPP", x, queue)
    mix_rec.check_total("NNLS's MTTKRP mix", run["launches"]["fused_mttkrp_tc"])
    mix = mttkrp_mix(mix_rec, torch.from_numpy(x).to("cuda"), "NNLS")
    # CALS against each model's ALS on the card (compare_als_cals), and the
    # models furthest apart again on the CPU, in float32 and in float64.
    ap = AlsParams(max_iterations=NN_ITERS, force_max_iter=True, update_method=UpdateMethod.NNLS, precision="high")

    def als_by_rank(xx, q, device=None, precision="high"):
        t0 = time.perf_counter()
        out = {}
        for r in sorted({kt.rank for kt in q}):
            ids = [i for i, kt in enumerate(q) if kt.rank == r]
            _, reps = cp_batched_als(xx, [q[i] for i in ids], dataclasses.replace(ap, precision=precision),
                                     device=device)
            out.update(zip(ids, reps))
        return out, time.perf_counter() - t0

    def rel_err_diff(cals, als):
        return abs(cals.approx_error - als.approx_error) / max(1.0, abs(als.approx_error))

    def in_dtype(ids, dt):
        return [Ktensor(tuple(f.astype(dt) for f in queue[i].factors), queue[i].lam.astype(dt)) for i in ids]

    als, als_s = als_by_rank(x, queue)
    fit_diff = {m.id: abs(m.fit - als[m.id].fit) for m in rep.models}
    rel = {m.id: rel_err_diff(m, als[m.id]) for m in rep.models}
    worst = sorted(rel, key=rel.get, reverse=True)[:NN_F64_WORST]
    print(f"NNLS CALS vs per-model ALS on the card: max |fit diff| {max(fit_diff.values()):.3e}; the JAX "
          f"experiment's relative error check: max {max(rel.values()):.3e}, {sum(v > 1e-1 for v in rel.values())} "
          f"models above 1e-1 (ranks {sorted(queue[i].rank for i in rel if rel[i] > 1e-1)}); ALS wall "
          f"{als_s:.2f}s", flush=True)
    if not max(fit_diff.values()) <= NN_FIT_TOL:
        raise AssertionError("NNLS: CALS fits differ from the models' ALS fits on the card")
    cpu = {}
    for name, dt, prec in (("float32", np.float32, "high"), ("float64", np.float64, "highest")):
        _, rep_w = cp_cals(x.astype(dt), in_dtype(worst, dt), nn_params(precision=prec), device="cpu")
        als_w, _ = als_by_rank(x.astype(dt), in_dtype(worst, dt), device="cpu", precision=prec)
        cpu[name] = {worst[m.id]: rel_err_diff(m, als_w[m.id]) for m in rep_w.models}
        print(f"NNLS CALS vs per-model ALS in {name} on the CPU, the {len(worst)} models furthest apart on the "
              f"card: relative error differences {cpu[name]} (the card's: {[rel[i] for i in worst]})", flush=True)
    if not max(cpu["float64"].values()) <= NN_F64_TOL:
        raise AssertionError("NNLS: CALS and ALS differ in float64")
    # Fits against the port's float64 CPU run at "highest".
    t0 = time.perf_counter()
    _, rep64 = cp_cals(x.astype(np.float64), in_dtype(NN_HELD, np.float64), nn_params(precision="highest"),
                       device="cpu")
    cpu_s = time.perf_counter() - t0
    fit_diffs = [abs(rep.models[i].fit - m.fit) for i, m in zip(NN_HELD, rep64.models)]
    print(f"NNLS vs CPU float64 ({len(NN_HELD)} models, {cpu_s:.1f}s on the CPU): max |fit diff| "
          f"{max(fit_diffs):.3e}", flush=True)
    if not max(fit_diffs) <= NN_HELD_TOL:
        raise AssertionError(f"NNLS: fits differ from the float64 CPU run by {max(fit_diffs)}")
    # Lawson-Hanson and BPP on one bucket on the card, each against the
    # float64 CPU run of that bucket, where the two agree.
    ids = [i for i, kt in enumerate(queue) if bucket_rank(kt.rank, NN_BUCKETS) == NN_LH_BUCKET]
    sub = [queue[i] for i in ids]
    b = f"bucket {NN_LH_BUCKET}"
    one = dict(bucket_ranks=(NN_LH_BUCKET,))
    nn_engine_run(f"Lawson-Hanson warm-up, {b}", x, sub[:2], nnls_algorithm="lawson_hanson", **one, **pinned())
    runs, fits, fits64 = {}, {}, {}
    for alg in ("lawson_hanson", "bpp"):
        _, rep_b, runs[alg] = nn_engine_run(f"{alg}, {b}", x, sub, nnls_algorithm=alg, **one, **pinned())
        fits[alg] = np.array([m.fit for m in rep_b.models])
        _, rep_b64 = cp_cals(x.astype(np.float64), in_dtype(ids, np.float64),
                             nn_params(precision="highest", nnls_algorithm=alg, **one), device="cpu")
        fits64[alg] = np.array([m.fit for m in rep_b64.models])
    agree = float(np.abs(fits64["lawson_hanson"] - fits64["bpp"]).max())
    ranks = np.array([kt.rank for kt in sub])
    vs64 = {}
    for alg in fits:
        d = np.abs(fits[alg] - fits64[alg])
        vs64[alg] = dict(max=float(d.max()), parting_ranks=ranks[d > 1e-4].tolist())
    lh_bpp = float(np.abs(fits["lawson_hanson"] - fits["bpp"]).max())
    print(f"NNLS on {b} ({len(sub)} models): float64 CPU Lawson-Hanson vs BPP max |fit diff| {agree:.3e}; card vs "
          f"float64: {vs64}; card Lawson-Hanson vs BPP {lh_bpp:.3e}; walls {runs['lawson_hanson']['wall_s']:.3f}s "
          f"vs {runs['bpp']['wall_s']:.3f}s", flush=True)
    if not agree <= NN_LH_F64_AGREE:
        raise AssertionError(f"NNLS: Lawson-Hanson and BPP differ in float64 by {agree}")
    for alg, v in vs64.items():
        if not v["max"] <= NN_LH_F64_TOL[alg]:
            raise AssertionError(f"NNLS: {alg} on {b} differs from the float64 CPU run by {v['max']}")
    times = nnls_update_times(x, res, queue)
    return dict(bpp=run, mttkrp_mix=mix, als_wall_s=als_s, max_fit_diff_vs_als=max(fit_diff.values()),
                max_rel_err_diff_vs_als=max(rel.values()), worst_vs_als=worst, cpu_cals_vs_als=cpu,
                max_fit_diff_vs_f64=max(fit_diffs), lawson_hanson_bucket=runs["lawson_hanson"],
                bpp_bucket=runs["bpp"], bucket_vs_f64=vs64, bucket_f64_lh_vs_bpp=agree,
                lh_vs_bpp_max_fit_diff=lh_bpp, update_times=times)


def line_search_phase(x_np, queue) -> dict:
    """Both line searches on the bench workload at "highest" (4d): the graph
    loop against sync_mode="iter" bit for bit, 20 models against the
    float64 CPU run; ERROR_CHECKING's candidate MTTKRP is predicated once
    per bucket-iteration (a fourth fused result per bucket-iteration)."""
    from cp_cals_tpu_torch import LineSearchMethod

    out = {}
    for method in LS_METHODS:
        kw = pinned(line_search=True, line_search_interval=LS_INTERVAL, max_iterations=LS_ITERS,
                    line_search_method=LineSearchMethod(method))
        ec = method == "error_checking"
        routes = {"fused": 4 if ec else 3}
        checked = "fused_mttkrp_fp32" if ec else None
        res_g, rep_g, run_g = engine_run(x_np, queue, {}, f"line search {method}", routes=routes, checked=checked,
                                         **kw)
        res_i, rep_i, run_i = engine_run(x_np, queue, {}, f"line search {method} iter", routes=routes,
                                         checked=checked, sync_mode="iter", **kw)
        assert_bit_identical(f"line search {method}: graph loop vs sync_mode='iter'", (res_g, rep_g), (res_i, rep_i))
        CROSS_TOL[f"line search {method}"] = LS_CROSS_TOL[method]
        check = cross_check(x_np, queue, {f"line search {method}": (res_g, rep_g)}, **kw)
        out[method] = dict(graph=run_g, iter=run_i, cross_check=check,
                           candidate_predicated=run_g["launches"]["fused_mttkrp_fp32.predicated"])
    return out


def jk_line_search_phase(x_np, kt5) -> dict:
    """J1 with NEC line search (tol-driven, as the bench's jackknife runs),
    then at 10 forced iterations against the port's float64 CPU run of
    JK_FIBERS (JK_CROSS_TOL)."""
    from cp_cals_tpu_torch import jk_cp_cals

    ls = dict(line_search=True, line_search_interval=LS_INTERVAL)
    _, run = jk_run("J1 NEC line search", lambda: jk_cp_cals(x_np, [kt5], jk_params(**ls)), fused("high"))
    want, _ = jk_reference(x_np, kt5, jk_params(force_max_iter=True, max_iterations=10, precision="highest",
                                                result_wire_dtype=None, **ls))
    rep = jk_cp_cals(x_np, [kt5], jk_params(force_max_iter=True, max_iterations=10, **ls))
    diffs = [replicate_diff(rep.results[0][f], w, f) for f, w in zip(JK_FIBERS, want)]
    rec, lam = max(d[0] for d in diffs), max(d[1] for d in diffs)
    print(f"cross-check J1 NEC line search (10 forced iterations, 10 fibers) vs CPU float64: max relative "
          f"reconstruction diff {rec:.3e}, max relative |lam| diff {lam:.3e}", flush=True)
    if not (rec <= JK_CROSS_TOL[0] and lam <= JK_CROSS_TOL[1]):
        raise AssertionError("jackknife line-search cross-check against the CPU float64 run failed")
    return dict(run=run, max_rel_recon_diff=rec, max_rel_lam_diff=lam)


def debug_phase() -> dict:
    """A debug=True cp_cals run on the card (eager: no graph captured) with
    an injected rise of the error at each model's 6th iteration, against
    the same float32 run on the CPU: equal entries (DEBUG_TOL)."""
    import warnings
    from unittest import mock

    from cp_cals_tpu_torch import CalsParams, cp_cals, random_ktensor_host
    from cp_cals_tpu_torch.solvers import iteration as it

    rng = np.random.default_rng(21)
    modes = (40, 30, 20)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float32)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 0.01 * rng.standard_normal(modes)).astype(np.float32)
    queue = [random_ktensor_host(rng, modes, r, dtype=np.float32) for r in (2, 3, 4, 3, 2, 4)]
    params = CalsParams(max_iterations=DEBUG_ITERS, force_max_iter=True, bucket_ranks=(4,), buffer_size=12,
                        epilogue="xla", debug=True, line_search=True, line_search_interval=4, **pinned())
    real = it.normalize_factor_fused

    def bumped(u, iters, *args):
        f, lam, gm = real(u, iters, *args)
        return f, torch.where((iters == 6)[:, None], lam * 1.05, lam), gm

    entries = {}
    for device in ("cuda", "cpu"):
        it.MONOTONICITY_VIOLATIONS.clear()
        with mock.patch.object(it, "normalize_factor_fused", bumped), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, rep = cp_cals(x, queue, params, device=device)
        entries[device] = list(it.MONOTONICITY_VIOLATIONS)
        if device == "cuda" and sum(c["captures"] for c in rep.loop_counts.values()):
            raise AssertionError("debug run: a graph was captured")
    it.MONOTONICITY_VIOLATIONS.clear()
    got, want = entries["cuda"], entries["cpu"]
    ok = bool(got) and len(got) == len(want) and all(
        a[0] == b[0] and abs(a[1] - b[1]) <= DEBUG_TOL * abs(b[1]) and abs(a[2] - b[2]) <= DEBUG_TOL * abs(b[2])
        for a, b in zip(got, want))
    print(f"debug run: {len(got)} entries on the card, {len(want)} on the CPU, equal: {ok}; card's {got}", flush=True)
    if not ok:
        raise AssertionError(f"debug run: entries differ: card {got}, CPU {want}")
    return dict(entries=got, cpu_entries=want)


def read_mean(rows, bucket_iters, key, field):
    """``weighted`` over the rows that have a reading (the inverses'
    library replays exist for R <= INV_EX_CAPTURE_R only)."""
    return weighted([row for row in rows if row[key][field] is not None], bucket_iters, key, field)


def mean_or_none(rows, bucket_iters, key, field, tier=None):
    """``weighted``, or None where a row has no reading."""
    if any((row[key][tier] if tier else row[key])[field] is None for row in rows):
        return None
    return weighted(rows, bucket_iters, key, field, tier)


def weighted(rows, bucket_iters, key, field, tier=None):
    """The mean of ``field`` over the rows, each weighted by its bucket's
    iterations: ``bucket_iters`` by bucket rank, or by (rank, mode) where
    only some modes of a bucket launch the kernel (``fused_weights``)."""
    num = den = 0.0
    for row in rows:
        w = bucket_iters.get((row["R"], row["mode"]), bucket_iters.get(row["R"], 0))
        entry = row[key][tier] if tier else row[key]
        num += w * entry[field]
        den += w
    if not den:
        raise AssertionError(f"{key} {tier or ''}: no launch in the run whose mix is asked for")
    return num / den


def fused_weights(run: dict, rep) -> dict:
    """{(bucket rank, mode): the bucket's iterations} of the modes a run
    under AUTO put on the fused MTTKRP kernels."""
    return {(r, n): rep.engine_iterations.get(r, 0) for r, (m, _) in picks_of(run).items()
            for n, method in enumerate(m) if method == "pallas"}


# ------------------------------------------------------------ entry points


# The README's command (python -m cp_cals_tpu_torch.cli ...): the CLI's own
# rank-5 299x301x41 target, 400 models of ranks 1-20, CALS, batched ALS and
# the jackknife of the best model of each rank (20 x 299 replicates).
README_CLI = ["-t", "299-301-41", "-c", "1:20:20", "--compare-als", "--jk"]
SPEC_SEED = 11  # api.cp_cals(init="random", seed=SPEC_SEED): seeds SPEC_SEED * 100003 + i
ENTRY_DIR = os.path.join("build", "chip_smoke")  # git-ignored scratch of the phase
CLI_LINES = {
    "tensor": r"^Tensor \((\d+), (\d+), (\d+)\), (\d+) models, ranks 1\.\.20$",
    "device": r"^Device: (.+)$",
    "cals": r"^CALS: ([\d.]+)s, ([\d.]+) models/s, mean fit ([-\d.]+), mean iters ([\d.]+)$",
    "als": r"^Batched ALS: ([\d.]+)s -> CALS speedup ([\d.]+)x$",
    "jk": r"^Jackknife: (\d+) replicates in ([\d.]+)s$",
}


def run_cli(name: str, argv: list, kernels: tuple, lines: tuple, x) -> tuple[dict, tuple]:
    """``cli.main(argv)`` from counts at 0, its MTTKRP, normal-inverse and
    apply calls recorded (replays included): its output lines (each of
    ``lines`` must appear, as CLI_LINES spells it), every kernel of
    ``kernels`` launched, its CSV's rows, and every recorded shape of each
    kernel held against its plain version and timed on the run's own
    inputs (``x``, the CLI's target on the card, for the twostep beside
    the MTTKRP). Returns that, and the CLI's CALS call (queue, params,
    (results, report))."""
    import contextlib
    import csv
    import io
    import re

    from cp_cals_tpu_torch import cli, solvers
    from cp_cals_tpu_torch.utils import lut

    csv_path = os.path.join(ENTRY_DIR, f"{name}.csv")
    buf = io.StringIO()
    real, calls = solvers.cp_cals, []

    def cals_call(xx, queue, params, **kw):
        out = real(xx, queue, params, **kw)
        calls.append((queue, params, out))
        return out

    torch.cuda.synchronize()
    reset_counts()
    lut.reset_lookup_stats()
    t0 = time.perf_counter()
    with MttkrpRecorder() as m_rec, HinvMixRecorder() as h_rec, ApplyMixRecorder() as a_rec:
        solvers.cp_cals = cals_call
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(argv + ["--csv", csv_path])
        finally:
            solvers.cp_cals = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"cli {name}| {line}", flush=True)
    got = {}
    for key in lines:
        m = [re.match(CLI_LINES[key], ln) for ln in text.splitlines()]
        m = [hit for hit in m if hit]
        if len(m) != 1:
            raise AssertionError(f"cli {name}: no single {key!r} line in its output")
        got[key] = m[0].groups()
    missing = [k for k in kernels if not counts.get(k)]
    if missing:
        raise AssertionError(f"cli {name}: {missing} never launched ({counts})")
    with open(csv_path, newline="") as fh:
        rows = list(csv.DictReader(fh, delimiter=";"))
    ranks = [r for r in range(1, 21) for _ in range(20)]
    if ([int(r["KTENSOR_ID"]) for r in rows] != list(range(400)) or [int(r["RANK"]) for r in rows] != ranks
            or not all(np.isfinite(float(r["ERROR"])) and 1 <= int(r["ITERS"]) <= 200 for r in rows)):
        raise AssertionError(f"cli {name}: its CSV's 400 rows are not the queue's")
    if got["device"][0] != torch.cuda.get_device_name(0) or got["tensor"] != tuple(str(m) for m in MODES) + ("400",):
        raise AssertionError(f"cli {name}: device or tensor line {got}")
    fit = float(got["cals"][2])
    if not 0.5 < fit <= 1.0:
        raise AssertionError(f"cli {name}: mean fit {fit}")
    if len(calls) != 1:
        raise AssertionError(f"cli {name}: {len(calls)} CALS calls")
    stats = lut_stats(f"cli {name}")  # its CALS and jackknife runs under AUTO; batched ALS reads no table
    print(f"cli {name}: wall {wall:.3f}s (its kernels' calls recorded), launches {counts}, lookup {stats}",
          flush=True)
    m_rec.check_total(f"cli {name}'s MTTKRP mix",
                      counts.get("fused_mttkrp_fp32", 0) + counts.get("fused_mttkrp_tc", 0))
    h_rec.check_total(f"cli {name}'s normal-inverse mix", counts.get("normal_inverse", 0))
    a_rec.check_total(f"cli {name}'s apply mix", counts.get("epilogue_apply", 0))
    mttkrp = mttkrp_mix(m_rec, x, f"cli {name}")
    mixes = {k: v for k, v in (
        ("fused_mttkrp_fp32", [m for m in mttkrp if m["tier"] == "highest"]),
        ("fused_mttkrp_tc", [m for m in mttkrp if m["tier"] != "highest"]),
        ("normal_inverse", hinv_mix(h_rec, f"cli {name}")),
        ("epilogue_apply", apply_mix(a_rec, f"cli {name}"))) if v}
    return dict(wall_s=wall, lines={k: list(v) for k, v in got.items()}, launches=counts, csv_rows=len(rows),
                mixes=mixes, lut_dispatch=stats), calls[0]


def cli_cross_check(x_cli, call) -> dict:
    """The README command's best model of each rank (the 20 its jackknife
    takes) against the port's float64 CPU run from the same init, forced
    to the iterations the card ran it, at the CLI's settings: |fit
    difference| and relative reconstruction difference, held to
    CLI_CROSS_TOL."""
    from cp_cals_tpu_torch import Ktensor, cp_cals

    queue, params, (results, rep) = call
    best = {}
    for m in rep.models:  # as the CLI picks them
        if m.rank not in best or m.approx_error < best[m.rank].approx_error:
            best[m.rank] = m
    x64 = x_cli.astype(np.float64)
    t0 = time.perf_counter()
    rows = []
    for r, m in sorted(best.items()):
        q = queue[m.id]
        q64 = Ktensor(tuple(f.astype(np.float64) for f in q.factors), q.lam.astype(np.float64))
        p = dataclasses.replace(params, max_iterations=m.iters, force_max_iter=True, bucket_ranks=(r,))
        (kt64,), rep64 = cp_cals(x64, [q64], p, device="cpu")
        a, b = dense(results[m.id]), dense(kt64)
        rows.append(dict(id=m.id, rank=r, iters=m.iters, fit=m.fit, fit64=rep64.models[0].fit,
                         fit_diff=abs(m.fit - rep64.models[0].fit),
                         rel_recon_diff=float(np.linalg.norm(a - b) / np.linalg.norm(b))))
    worst_fit = max(row["fit_diff"] for row in rows)
    worst_rec = max(row["rel_recon_diff"] for row in rows)
    print(f"cli readme cross-check vs CPU float64 (the best model of each rank, {time.perf_counter() - t0:.1f}s): "
          f"max |fit diff| {worst_fit:.3e}, max relative reconstruction diff {worst_rec:.3e}; by rank "
          + ", ".join(f"{row['rank']}: {row['iters']} it {row['fit_diff']:.1e}/{row['rel_recon_diff']:.1e}"
                      for row in rows), flush=True)
    if not (worst_fit <= CLI_CROSS_TOL[0] and worst_rec <= CLI_CROSS_TOL[1]):
        raise AssertionError("cli readme: its best models differ from the CPU float64 runs")
    return dict(max_fit_diff=worst_fit, max_rel_recon_diff=worst_rec, models=rows)


def tol_intake(x_np) -> dict:
    """api.cp_cals at its defaults (init="random": tol-driven, at most 200
    iterations, evict_batch 1, buffer 4200, buckets 4/8/16/32) on the bench
    tensor, ranks 1-20 x 20, against the same call on the spec_to_ktensor
    queue built on the host, in turns (seeds, host, host, seeds): walls,
    bucket setup and eviction-round times, spec builds; the results bit
    for bit."""
    from cp_cals_tpu_torch import api
    from cp_cals_tpu_torch.ktensor import spec_to_ktensor, to_host

    ranks = [r for r in range(1, 21) for _ in range(20)]
    t0 = time.perf_counter()
    specs = api._init_models(MODES, ranks, "random", torch.float32, SPEC_SEED)
    host = [to_host(spec_to_ktensor(s)) for s in specs]
    materialize_s = time.perf_counter() - t0
    real, reports = api._cp_cals_solver, []

    def solver(*a, **kw):
        out = real(*a, **kw)
        reports.append(out[1])
        return out

    from cp_cals_tpu_torch.utils import lut

    runs = {"seeds": [], "host": []}
    lut.reset_lookup_stats()
    api._cp_cals_solver = solver
    try:
        for kind in ("seeds", "host", "host", "seeds"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = api.cp_cals(x_np, ranks, init="random" if kind == "seeds" else host, seed=SPEC_SEED)
            torch.cuda.synchronize()
            rep = reports[-1]
            runs[kind].append(dict(wall_s=time.perf_counter() - t0, fit=fit, rep=rep, **engine_walls(rep),
                                   spec_builds=sum(c["spec_builds"] for c in rep.loop_counts.values()),
                                   rounds=loop_totals(rep)["stats_fetches"]))
    finally:
        api._cp_cals_solver = real
    stats = lut_stats("api.cp_cals at its defaults")
    (a, b) = (runs["seeds"][0], runs["host"][0])
    assert_bit_identical("api.cp_cals at its defaults: seeds vs the host-built queue",
                         (a["fit"].ktensors, a["rep"]), (b["fit"].ktensors, b["rep"]))
    out = {k: [{f: v for f, v in run.items() if f not in ("fit", "rep")} for run in rs] for k, rs in runs.items()}
    out.update(materialize_s=materialize_s, mean_iters=float(np.mean(a["fit"].iters)),
               mean_fit=float(np.mean(a["fit"].fits)), lut_dispatch=stats)
    print(f"api.cp_cals defaults (tol-driven, mean iters {out['mean_iters']:.1f}): "
          + "; ".join(f"{k} walls {[round(r['wall_s'], 4) for r in v]} s, setup "
                      f"{[round(r['setup'], 4) for r in v]} s, eviction rounds {[round(r['evict'], 4) for r in v]} s, "
                      f"spec builds {v[0]['spec_builds']}, stats fetches {v[0]['rounds']}"
                      for k, v in out.items() if k in runs)
          + f"; the host queue built in {materialize_s:.3f}s", flush=True)
    return out


def engine_walls(rep) -> dict:
    return {k: sum(pt.get(k, 0.0) for pt in rep.phase_times.values()) for k in ("setup", "evict", "checkpoint")}


def entry_point_phase(x_np, dev) -> dict:
    """The user entry points at full width (module docstring, phase 6b)."""
    import shutil

    from cp_cals_tpu_torch import api, cp_cals
    from cp_cals_tpu_torch.ktensor import random_ktensor, spec_to_ktensor, to_host, to_tensor
    from cp_cals_tpu_torch.prng import prng_key, split
    from cp_cals_tpu_torch.tensor_io import read_tensor, write_tensor
    from cp_cals_tpu_torch.utils.timers import RunTrace

    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    os.makedirs(ENTRY_DIR)
    out = {}
    # 1. The README's command: the fp32 MTTKRP ("highest") and the epilogue,
    # every shape they ran at held against their plain versions, and its
    # best models against float64 runs on the CPU.
    kx = split(prng_key(0, dev), 3)[0]
    x_cli_d = to_tensor(random_ktensor(kx, MODES, 5))  # the CLI's target at seed 0
    x_cli = x_cli_d.cpu().numpy()
    out["readme_cli"], call = run_cli("readme", README_CLI,
                                      ("fused_mttkrp_fp32", "normal_inverse", "epilogue_apply"),
                                      ("tensor", "device", "cals", "als", "jk"), x_cli_d)
    n_reps = int(out["readme_cli"]["lines"]["jk"][0])
    if n_reps != 20 * MODES[0]:
        raise AssertionError(f"cli readme: {n_reps} replicates, expected {20 * MODES[0]}")
    out["readme_cli"]["cross_check"] = cli_cross_check(x_cli, call)
    del call
    # 2. The same target through a tensor file, at the --fast tier.
    path = os.path.join(ENTRY_DIR, "cli_tensor.txt")
    t0 = time.perf_counter()
    write_tensor(path, x_cli)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read_tensor(path)
    read_s = time.perf_counter() - t0
    if not np.array_equal(back, x_cli.astype(np.float64)):
        raise AssertionError("tensor file: the read-back differs from the written array")
    size = os.path.getsize(path)
    print(f"tensor file: {size} bytes, write {write_s:.3f}s, read {read_s:.3f}s, read-back equal", flush=True)
    out["tensor_file"] = dict(bytes=size, write_s=write_s, read_s=read_s)
    out["fast_cli"] = run_cli("fast", ["--tensor-file", path, "-c", "1:20:20", "--fast", "--wire", "float16"],
                              ("fused_mttkrp_tc",), ("tensor", "device", "cals"), x_cli_d)[0]
    os.remove(path)
    out["tol_intake"] = tol_intake(x_np)

    # 3. api.cp_cals with device-generated inits against the same run on
    # the spec_to_ktensor queue built on the host.
    ranks = [r for r in range(1, 21) for _ in range(20)]
    from cp_cals_tpu_torch.utils import lut

    opts = dict(bucket_ranks=BUCKETS, buffer_size=BUFFER, maxiters=ITERS, force_max_iter=True, tol=1e-6)
    reset_counts()
    lut.reset_lookup_stats()
    t0 = time.perf_counter()
    fit = api.cp_cals(x_np, ranks, init="random", seed=SPEC_SEED, **opts)
    api_s = time.perf_counter() - t0
    specs = fit.initial
    params = api._make_params(**opts)
    res_s, rep_s = cp_cals(x_np, specs, params)
    t0 = time.perf_counter()
    host = [to_host(spec_to_ktensor(s)) for s in specs]
    materialize_s = time.perf_counter() - t0
    res_m, rep_m = cp_cals(x_np, host, params)
    assert_bit_identical("api.cp_cals(init='random') vs the spec_to_ktensor queue", (fit.ktensors, rep_s),
                         (res_m, rep_m))
    if (fit.iters, fit.fits, fit.errors) != ([m.iters for m in rep_m.models], [m.fit for m in rep_m.models],
                                               [m.approx_error for m in rep_m.models]):
        raise AssertionError("api.cp_cals: its reports differ from the materialized run's")
    assert_bit_identical("engine spec queue vs the spec_to_ktensor queue", (res_s, rep_s), (res_m, rep_m))
    lut_stats("spec intake")
    setup = dict(spec=engine_walls(rep_s)["setup"], host=engine_walls(rep_m)["setup"])
    print(f"spec intake: api wall {api_s:.3f}s; bucket setup {setup['spec']:.4f}s from seeds on the card vs "
          f"{setup['host']:.4f}s from host-built models (spec_to_ktensor + to_host of 400 models "
          f"{materialize_s:.3f}s before it)", flush=True)
    out["spec_intake"] = dict(api_wall_s=api_s, setup_s=setup, materialize_s=materialize_s,
                              mean_fit=float(np.mean(fit.fits)))

    # 4. Checkpoint, cut and resume, against the uninterrupted run; then
    # the trace: untraced, traced, untraced.
    ck_params = bench_params()

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, rep = cp_cals(x_np, specs, ck_params, **kw)
        torch.cuda.synchronize()
        return res, rep, time.perf_counter() - t0

    # Untraced and traced in turns (U T T U U T): each kind's first run
    # is checked, the walls of all are kept.
    walls = {"untraced": [], "traced": []}
    firsts = {}
    lut.reset_lookup_stats()
    for kind in ("untraced", "traced", "traced", "untraced", "untraced", "traced"):
        trace = RunTrace() if kind == "traced" else None
        res, rep, wall = timed(trace=trace)
        walls[kind].append(wall)
        firsts.setdefault(kind, (res, rep, trace))
    (want, rep_w, _), (res_t, rep_t, trace) = firsts["untraced"], firsts["traced"]
    plain_s = walls["untraced"][0]
    ck_dir = os.path.join(ENTRY_DIR, "ckpt")
    part, rep_p, cut_s = timed(checkpoint_dir=ck_dir, max_rounds_per_bucket=1)
    if not any(k is None for k in part):
        raise AssertionError("checkpoint: the cut run finished every model")
    disk = sum(os.path.getsize(os.path.join(ck_dir, f)) for f in os.listdir(ck_dir))
    got, rep_g, resume_s = timed(checkpoint_dir=ck_dir, resume=True)
    assert_bit_identical("checkpoint cut + resume vs uninterrupted", (want, rep_w), (got, rep_g))
    lut_stats("checkpoint and trace")
    n_ck = sum(c["checkpoints"] for r in (rep_p, rep_g) for c in r.loop_counts.values())
    ck_s = engine_walls(rep_p)["checkpoint"] + engine_walls(rep_g)["checkpoint"]
    disk_end = sum(os.path.getsize(os.path.join(ck_dir, f)) for f in os.listdir(ck_dir))
    print(f"checkpoint: cut run {cut_s:.3f}s ({sum(k is None for k in part)} models unfinished), resumed "
          f"{resume_s:.3f}s, uninterrupted {plain_s:.3f}s; {n_ck} snapshots, {ck_s / n_ck * 1e3:.1f} ms each; "
          f"{disk} bytes on disk after the cut, {disk_end} at the end", flush=True)
    out["checkpoint"] = dict(cut_s=cut_s, resume_s=resume_s, plain_s=plain_s, snapshots=n_ck,
                             s_per_snapshot=ck_s / n_ck, bytes_after_cut=disk, bytes_at_end=disk_end)
    n_iter = sum(rep_t.engine_iterations.values())
    fetches = (loop_totals(rep_t)["stats_fetches"], loop_totals(rep_w)["stats_fetches"])
    if len(trace.records) != n_iter or fetches[0] != fetches[1]:
        raise AssertionError(f"trace: {len(trace.records)} records for {n_iter} iterations, "
                             f"stats fetches {fetches} (traced, untraced)")
    assert_bit_identical("traced vs untraced", (want, rep_w), (res_t, rep_t))
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"trace: {len(trace.records)} records = engine iterations, {fetches[0]} stats fetches as untraced; "
          f"walls in turns (U T T U U T) untraced {walls['untraced']}, traced {walls['traced']} s; medians "
          f"{med['untraced']:.4f} / {med['traced']:.4f} s", flush=True)
    out["trace"] = dict(records=len(trace.records), stats_fetches=fetches[0], walls_s=walls, median_s=med)
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    return out


# ----------------------------------------------------------- experiments


EXP_DIR = os.path.join("chiprun_out", "experiments_quick")  # the quick run's CSVs and experiments.json
EXP_FILE = os.path.join("build", "chip_smoke_experiments", "jk_file.txt")  # written by the phase, removed after
# The --jk-file tensor: a synthetic rank-5 Ktensor of these modes plus 5 %
# noise (seed EXP_FILE_SEED), in the reference text format. The
# reference's stjohns.txt and wine.txt are not in the repository.
EXP_FILE_MODES, EXP_FILE_SEED, EXP_FILE_RANKS = (40, 60, 50), 5, (4, 5, 6)
# The harness's engine settings (cp_cals_tpu_torch/experiments.py), for the
# tables of its buckets: the base grid's and the defrag study's buckets,
# the jackknife runs' (and their ranks); the scale sweep's are
# experiments.SWEEP_SETTINGS.
EXP_BUCKETS, EXP_JK_BUCKETS, EXP_JK_RANKS = (4, 8, 12, 16, 20), (4, 8, 12), (3, 5, 7, 9)
# The full-width legs: the base grid at 200^3 with the paper's queue (ranks
# 1-20 x 20, 50 forced iterations), and the scale sweep at the paper's
# 500^3 in float32, cut in depth: 25 copies a rank (500 models) in place of
# 250, 10 forced iterations in place of 50.
EXP_BASE_MODES, EXP_BASE_ITERS = (200, 200, 200), 50
EXP_SWEEP = dict(modes=(500, 500, 500), copies=25, max_iter=10)


def write_jk_file(path: str) -> None:
    """The --jk-file tensor (``EXP_FILE_MODES``) in the reference text
    format, at ``path``."""
    from cp_cals_tpu_torch.ktensor import random_ktensor_host
    from cp_cals_tpu_torch.tensor_io import write_tensor

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.default_rng(EXP_FILE_SEED)
    kt = random_ktensor_host(rng, EXP_FILE_MODES, 5, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    write_tensor(path, x + 0.05 * x.std() * rng.standard_normal(EXP_FILE_MODES))


def experiment_tables() -> list:
    """(modes, tier, {bucket rank: batch}) of every ``cp_cals`` run of the
    experiment harness, from the engine's allocation: the quick legs and
    this script's full-width legs (``experiments_phase``), and the
    full-size run (``python3 -m cp_cals_tpu_torch.experiments --large
    --jk --jk-scale --scale-sweep --defrag --nnls --jk-file``), whose NNLS
    leg is phase 4c's queue. The jackknife runs fit one model per rank
    and then run each model's mode-0 replicates; the real-data jackknife
    also runs each model's replicates alone (``jk_cp_batched_als``: one
    bucket of its rank)."""
    from cp_cals_tpu_torch import CalsParams
    from cp_cals_tpu_torch.experiments import SWEEP_SETTINGS as sweep

    buffer = CalsParams().buffer_size

    def grid(rmax, copies):
        return [r for r in range(1, rmax + 1) for _ in range(copies)]

    def jk(modes, ranks, buckets):
        reps = [r for r in ranks for _ in range(modes[0])]
        return [(modes, "high", engine_batches(ranks, buckets, buffer)),
                (modes, "high", engine_batches(reps, buckets, buffer))]

    out = [(modes, "highest", engine_batches(grid(rmax, copies), EXP_BUCKETS, buffer))
           for modes, rmax, copies in (((50, 50, 50), 3, 2), ((100, 100, 100), 20, 20),
                                       (EXP_BASE_MODES, 20, 20), ((300, 300, 300), 20, 20))]
    out.append(((30, 30, 30), "high", engine_batches(grid(3, 2), EXP_JK_BUCKETS, buffer)))  # quick NNLS
    for modes in ((20, 30, 30), (50, 100, 100), (50, 200, 200), (50, 400, 400)):
        out += jk(modes, EXP_JK_RANKS, EXP_JK_BUCKETS)
    out += jk(EXP_FILE_MODES, EXP_FILE_RANKS, tuple(sorted(set(EXP_FILE_RANKS))))
    out += [(EXP_FILE_MODES, "high", engine_batches([r] * EXP_FILE_MODES[0], (r,), buffer)) for r in EXP_FILE_RANKS]
    top = sweep["rank_max"]
    for modes, rmax, copies in (((30, 25, 20), 6, 3), (EXP_SWEEP["modes"], top, EXP_SWEEP["copies"]),
                                ((500, 500, 500), top, 250)):
        out.append((modes, sweep["precision"], engine_batches(grid(rmax, copies), sweep["bucket_ranks"],
                                                              sweep["buffer_size"])))
    for modes, rmax, copies in (((30, 30, 30), 4, 2), ((200, 200, 200), 20, 20)):
        out.append((modes, "high", engine_batches(grid(rmax, copies), EXP_BUCKETS, buffer)))
    return out


def exp_label(modes, params, jk: bool) -> str:
    """A name for one engine run of the harness: its tensor, tier and kind."""
    from cp_cals_tpu_torch import UpdateMethod

    kind = ("nnls" if params.update_method == UpdateMethod.NNLS else "jk" if jk
            else "evict_first" if params.always_evict_first else "cals")
    return f"{'x'.join(map(str, modes))} {params.mttkrp_precision or params.precision} {kind}"


class EngineRuns:
    """Every ``cp_cals`` call of the experiment harness, checked as it
    returns: the harness calls ``solvers.cp_cals`` and the jackknife
    drivers ``cals.cp_cals`` through ``solvers.jackknife``; both names are
    wrapped. Each call's launches and MTTKRP results by route are what it
    added to the counts (the harness's own per-leg counts run on), and must
    equal its buckets' picks from the committed tables, with no decision
    left to the heuristic (``check_table_run``). ``autotunes`` counts
    ``utils/lut.autotune`` calls (a table miss)."""

    def __init__(self):
        self.runs, self.autotunes = [], 0

    def __enter__(self):
        from cp_cals_tpu_torch import solvers
        from cp_cals_tpu_torch.solvers import jackknife
        from cp_cals_tpu_torch.utils import lut

        self.saved = [(solvers, "cp_cals", solvers.cp_cals), (jackknife, "cp_cals", jackknife.cp_cals),
                      (lut, "autotune", lut.autotune)]
        solvers.cp_cals = jackknife.cp_cals = self.wrap(solvers.cp_cals)
        real_tune = lut.autotune

        def counted_tune(*a, **kw):
            self.autotunes += 1
            return real_tune(*a, **kw)

        lut.autotune = counted_tune
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def wrap(self, real):
        from cp_cals_tpu_torch import UpdateMethod, launches
        from cp_cals_tpu_torch.utils import lut

        def run(x, queue, params, *a, **kw):
            counts0, routes0, stats0 = read_counts(), launches.routes(), dict(lut.LOOKUP_STATS)
            lut.reset_lookup_stats()
            t0 = time.perf_counter()
            out = real(x, queue, params, *a, **kw)
            wall = time.perf_counter() - t0
            counts = {k: v - counts0[k] for k, v in read_counts().items()}
            routes = {k: v - routes0[k] for k, v in launches.routes().items()}
            modes = tuple(x.shape)
            label = exp_label(modes, params, kw.get("jk_fibers") is not None)
            picked = check_table_run(f"experiments {label}", modes, [kt.rank for kt in queue], params, out[1],
                                     counts, routes, epilogue=params.update_method != UpdateMethod.NNLS)
            for k, v in stats0.items():
                lut.LOOKUP_STATS[k] += v
            self.runs.append(dict(label=label, n_models=len(queue), wall_s=wall, launches=counts, routes=routes,
                                  bucket_iterations=dict(out[1].engine_iterations), **picked))
            return out

        return run

    def launches_by_label(self) -> dict:
        """{kernel: {run label: launches}}, summed over the runs of a label."""
        out = collections.defaultdict(lambda: collections.defaultdict(int))
        for run in self.runs:
            for k, v in run["launches"].items():
                if v:
                    out[k][run["label"]] += v
        return {k: dict(v) for k, v in out.items()}


def finite_numbers(name: str, obj) -> None:
    """Every number in a (nested) result is finite."""
    if isinstance(obj, dict):
        for v in obj.values():
            finite_numbers(name, v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            finite_numbers(name, v)
    elif isinstance(obj, (int, float)) and not np.isfinite(obj):
        raise AssertionError(f"{name}: a number is not finite: {obj}")


def experiments_phase(dev) -> dict:
    """The experiment harness (cp_cals_tpu_torch/experiments.py) on the card:
    every leg at --quick sizes through ``experiments.main`` (the jackknife
    file written here with tensor_io), the base grid at full width
    (``compare_als_cals`` at 200^3, ranks 1-20 x 20, 50 forced iterations,
    buckets 4/8/12/16/20, "highest") and the scale sweep at the paper's
    500^3 float32, cut in depth (``EXP_SWEEP``). Every engine run is
    checked against the committed tables' picks (``EngineRuns``); no table
    may miss (no autotune), no comparison may mismatch, the 500^3 sweep
    must hold its layouts ("auto" resolves to "materialized": 1.512 GB of
    hi/lo layouts fit a quarter of the card), every number must be
    finite."""
    import shutil

    from cp_cals_tpu_torch import AlsParams, CalsParams, experiments
    from cp_cals_tpu_torch.utils.roofline import device_peaks, mxu_utilization

    shutil.rmtree(os.path.dirname(EXP_FILE), ignore_errors=True)
    shutil.rmtree(EXP_DIR, ignore_errors=True)
    write_jk_file(EXP_FILE)
    t_phase = time.perf_counter()
    out = {}
    try:
        with EngineRuns() as runs:
            t0 = time.perf_counter()
            out["quick"] = experiments.main(
                ["--quick", "--jk", "--jk-scale", "--scale-sweep", "--defrag", "--nnls", "--jk-file", EXP_FILE,
                 "--out", EXP_DIR])
            out["quick_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            x, queue = experiments.make_workload(EXP_BASE_MODES, 1, 20, 20, device=dev)
            tag = "x".join(map(str, EXP_BASE_MODES))
            out[tag] = experiments.compare_als_cals(
                x, queue, CalsParams(max_iterations=EXP_BASE_ITERS, force_max_iter=True, bucket_ranks=EXP_BUCKETS),
                AlsParams(max_iterations=EXP_BASE_ITERS, force_max_iter=True), out_dir=EXP_DIR, tag=tag, device=dev)
            out[tag]["leg_s"] = time.perf_counter() - t0
            del x, queue
            print(f"experiments base grid {tag}: {out[tag]}", flush=True)
            t0 = time.perf_counter()
            out["scale_sweep"] = experiments.scale_sweep(device=dev, **EXP_SWEEP)
            out["scale_sweep"]["leg_s"] = time.perf_counter() - t0
            print(f"experiments scale sweep {EXP_SWEEP}: {out['scale_sweep']}", flush=True)
    finally:
        shutil.rmtree(os.path.dirname(EXP_FILE), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["runs"], out["autotunes"] = runs.runs, runs.autotunes
    out["launches_by_label"] = runs.launches_by_label()

    quick = out["quick"]
    comparisons = {"quick " + k: quick[k] for k in ("50x50x50", "nnls")}
    comparisons[tag] = out[tag]
    for name, res in comparisons.items():
        if res["n_mismatched"]:
            raise AssertionError(f"experiments {name}: {res['n_mismatched']} of {res['n_models']} models apart "
                                 f"from their batched ALS beyond the 1e-1 check")
    if runs.autotunes:
        raise AssertionError(f"experiments: {runs.autotunes} autotunes inside the harness (a table misses; "
                             f"python3 tools/lut_tables.py measures chip_smoke.experiment_tables())")
    for name, sweep in (("quick scale sweep", quick["scale_sweep"]), ("scale sweep", out["scale_sweep"])):
        if sweep["lut_dispatch"]["heuristic"] or sweep["lut_dispatch"]["nearest"]:
            raise AssertionError(f"experiments {name}: lookup decisions {sweep['lut_dispatch']}, all exact expected")
        if "hbm_measured" not in sweep:
            raise AssertionError(f"experiments {name}: no hbm_measured on the card")
    if out["scale_sweep"]["mode_layouts_resolved"] != "materialized":
        raise AssertionError(f"experiments scale sweep: layouts {out['scale_sweep']['mode_layouts_resolved']}, "
                             f"expected 'materialized' at {EXP_SWEEP['modes']}")
    with open(os.path.join(EXP_DIR, "experiments.json")) as fh:
        if json.load(fh) != json.loads(json.dumps(quick)):
            raise AssertionError("experiments: experiments.json is not the quick run's results")
    finite_numbers("experiments", {k: v for k, v in out.items() if k != "runs"})
    finite_numbers("experiments runs", [{k: v for k, v in r.items() if k != "picks"} for r in out["runs"]])

    sheet = device_peaks(dev)
    sweep = out["scale_sweep"]
    out["mxu_utilization_high"] = mxu_utilization(sweep["mttkrp_tflops"], "high", dev)
    print(f"experiments: peaks measured bf16 {quick['peak_bf16_tflops']} TFLOP/s (data sheet "
          f"{sheet['bf16_tflops']}), fp32 {quick['peak_f32_tflops']} (data sheet {sheet['fp32_tflops']}); "
          f"500^3 sweep {sweep['models_per_sec']} models/s, mttkrp {sweep['mttkrp_tflops']} TFLOP/s, "
          f"mxu_utilization at 'high' {out['mxu_utilization_high']:.4f}; peak HBM "
          f"{sweep['hbm_measured']['peak_bytes_in_use'] / 2**30:.2f} GiB of "
          f"{sweep['hbm_measured']['bytes_limit'] / 2**30:.2f}; {len(runs.runs)} engine runs checked against the "
          f"tables; phase {out['seconds']:.1f}s", flush=True)
    return out


# The stress phase: the JAX package's slow lane (tests/test_stress_oracle.py,
# the reference's SimpleCorrectness and jackknife FunctionCorrectness at full
# size) on the card. Every draw is the port's threefry (prng.py: JAX's keys,
# the uniform draws bit for bit), made in float64 on the CPU, so the CPU tests
# (tests/test_torch_stress.py, tests/test_torch_stress_oracle.py) and the card
# start from the same inputs.
STRESS_MODES = (13, 12, 11)  # the reference's stress tensor (test_cals.cpp:45)
STRESS_COPIES = 30  # models of each rank 1-12: 360
STRESS_ALS = dict(tol=1e-5, max_iterations=1000)
STRESS_ENGINE = dict(buffer_size=30, bucket_ranks=(2, 4, 8, 12))  # the reference's stress budget
STRESS_FORCED = dict(tol=1e-5, max_iterations=30, force_max_iter=True)  # S2: every path runs 30 iterations
STRESS_TOL = 1e-11  # the reference's MODEL_DIFF_ACC: float64 paths against each other
JK_STRESS_MODES = (10, 21, 20)
JK_STRESS = dict(tol=1e-4, max_iterations=60, force_max_iter=True)
JK_STRESS_ENGINE = dict(buffer_size=18, bucket_ranks=(5,))
STRESS_PATHS = ("cp_cals", "cp_als", "cp_batched_als")
# S1's sequential cp_als oracle runs on every STRESS_ALS_EVERY-th model of
# the queue (indices 0, 3, ..., 357: 120 of the 360), a cut by index made
# before any run: on an NVIDIA H100 80GB HBM3 at 700 W the float64 cp_als
# of all 360 took 64.0 s of the phase's 113.5 s (PERF.md), over the
# phase's 90 s budget.
STRESS_ALS_EVERY = 3
# S2's float32 paths at "highest" (the fp32 MTTKRP, normal-inverse and apply
# kernels) against the float64 run of the same forced settings: the largest
# |fit difference| and the largest reconstruction difference relative to
# |X|, over the 360 models; two float32 paths against each other are held
# to twice these (each within them of the float64 run). S3's float32
# jk_cp_cals against the float64 one: the largest replicate reconstruction
# difference relative to |X|, the left-out row dropped. Set from the port's
# float32 CPU run against the float64 CPU run of the same settings
# (tools/stress_bounds.py, 8 threads): S2 reads 3.157e-4 / 7.846e-5
# (cp_cals; cp_als 2.326e-4 / 8.509e-6, cp_batched_als 2.550e-4 /
# 1.152e-5; the paths against each other at most 2.921e-4 / 8.819e-5), S3
# 2.452e-7. The fits differ at the float32 FastALS error's resolution (its
# err^2 cancels to a few 1e-8 of |X|^2 on this exact rank-10 target); the
# models of rank above 10 move most. The limits give the CPU readings about
# 10x room for the card's other summation orders.
STRESS_CROSS_TOL = (4e-3, 8e-4)
JK_STRESS_CROSS_TOL = 3e-6


def stress_workload(copies: int = STRESS_COPIES):
    """The slow lane's SimpleCorrectness workload as host float64 NumPy: the
    exact rank-10 target of key 0, and ``copies`` models of each rank 1-12
    shuffled by ``random.Random(0)``, model i drawn from key 1000 + i.
    Returns (x, ranks, models)."""
    import random

    from cp_cals_tpu_torch.ktensor import random_ktensor, to_host, to_tensor
    from cp_cals_tpu_torch.prng import prng_key

    x = to_tensor(random_ktensor(prng_key(0), STRESS_MODES, 10, dtype=torch.float64)).numpy()
    ranks = [r for r in range(1, 13) for _ in range(copies)]
    random.Random(0).shuffle(ranks)
    kts = [to_host(random_ktensor(prng_key(1000 + i), STRESS_MODES, r, dtype=torch.float64))
           for i, r in enumerate(ranks)]
    return x, ranks, kts


def jk_stress_problem(device):
    """The slow lane's jackknife problem: the rank-5 10x21x20 target of key
    3 (host float64) and four rank-5 models (keys 50-53) fitted by cp_als
    on ``device`` with forced iterations. Returns (x, fitted host models)."""
    from cp_cals_tpu_torch import AlsParams, cp_als
    from cp_cals_tpu_torch.ktensor import random_ktensor, to_tensor
    from cp_cals_tpu_torch.prng import prng_key

    x = to_tensor(random_ktensor(prng_key(3), JK_STRESS_MODES, 5, dtype=torch.float64)).numpy()
    inits = [random_ktensor(prng_key(50 + i), JK_STRESS_MODES, 5, dtype=torch.float64) for i in range(4)]
    return x, [cp_als(x, kt0, AlsParams(**JK_STRESS), device=device)[0] for kt0 in inits]


def as_float32(x, kts):
    """A float64 problem cast to float32 (the target and the models)."""
    from cp_cals_tpu_torch import Ktensor

    return x.astype(np.float32), [Ktensor(tuple(f.astype(np.float32) for f in kt.factors),
                                          kt.lam.astype(np.float32)) for kt in kts]


class ChurnCounts:
    """The engine's eviction rounds, evicted models, refills, refilled slots
    and tail compactions while the block runs: its calls of
    ``_evict_col_indices``, ``_Loop.refill`` and ``ChunkLoop.compacted``
    (solvers/cals.py, solvers/graph_loop.py) counted."""

    def __enter__(self):
        from cp_cals_tpu_torch.solvers import cals, graph_loop

        self.counts = dict(eviction_rounds=0, evicted=0, refills=0, refilled_slots=0, compactions=0)
        self.real = (cals._evict_col_indices, graph_loop._Loop.refill, graph_loop.ChunkLoop.compacted)
        evict_cols, refill, compacted = self.real
        c = self.counts

        def counted_evict_cols(evicted, slot_meta):
            c["eviction_rounds"] += 1
            c["evicted"] += len(evicted)
            return evict_cols(evicted, slot_meta)

        def counted_refill(loop, slots, fresh):
            c["refills"] += 1
            c["refilled_slots"] += len(slots)
            return refill(loop, slots, fresh)

        def counted_compacted(loop, idx):
            c["compactions"] += 1
            return compacted(loop, idx)

        cals._evict_col_indices = counted_evict_cols
        graph_loop._Loop.refill = counted_refill
        graph_loop.ChunkLoop.compacted = counted_compacted
        return self.counts

    def __exit__(self, *exc):
        from cp_cals_tpu_torch.solvers import cals, graph_loop

        cals._evict_col_indices, graph_loop._Loop.refill, graph_loop.ChunkLoop.compacted = self.real


def timed_call(dev, fn):
    """``fn()`` from launch counts at 0: (its result, wall seconds, launches)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def stress_paths(x, ranks, kts, als: dict, dev, paths=STRESS_PATHS, als_every: int = 1, **tier) -> dict:
    """``paths`` of the stress workload on ``dev``: cp_cals on the queue
    ``kts`` (STRESS_ENGINE's budget, MTTKRP pinned to the fused kernels,
    which take the twostep in float64), cp_als on every ``als_every``-th
    model, cp_batched_als on each same-rank group, each with ALS settings
    ``als`` and ``tier``. Each path's host results, iteration counts and
    fits, in the order of its ``index`` (the queue indices it ran), wall
    and launches; the engine run's churn (``ChurnCounts``), graph loop
    counts, capture seconds and bucket-iterations."""
    from cp_cals_tpu_torch import AlsParams, CalsParams, cp_als, cp_batched_als, cp_cals

    out = {}
    if "cp_cals" in paths:
        with ChurnCounts() as churn:
            (res, rep), wall, counts = timed_call(
                dev, lambda: cp_cals(x, kts, CalsParams(**als, **STRESS_ENGINE, **tier, **pinned()), device=dev))
        if len(res) != len(kts) or any(kt is None for kt in res):
            raise AssertionError("stress cp_cals: missing results")
        out["cp_cals"] = dict(
            index=list(range(len(kts))), results=res, iters=[m.iters for m in rep.models],
            fits=[m.fit for m in rep.models], wall_s=wall, launches=counts, churn=dict(churn), loop=loop_totals(rep), steps=sum(rep.engine_iterations.values()),
            bucket_iterations=dict(rep.engine_iterations),
            capture_s=sum(pt.get("capture", 0.0) for pt in rep.phase_times.values()))
    params = AlsParams(**als, **tier)
    if "cp_als" in paths:
        index = list(range(0, len(kts), als_every))
        fits, wall, counts = timed_call(dev, lambda: [cp_als(x, kts[i], params, device=dev) for i in index])
        out["cp_als"] = dict(index=index, results=[kt for kt, _ in fits], iters=[r.iters for _, r in fits],
                             fits=[r.fit for _, r in fits], wall_s=wall, launches=counts,
                             steps=sum(r.iters for _, r in fits))
    if "cp_batched_als" in paths:
        groups: dict = {}
        for i, r in enumerate(ranks):
            groups.setdefault(r, []).append(i)

        def batched():
            got = {}
            for idx in groups.values():
                res, reps = cp_batched_als(x, [kts[i] for i in idx], params, device=dev)
                got.update(zip(idx, zip(res, reps)))
            return [got[i] for i in range(len(kts))]

        fits, wall, counts = timed_call(dev, batched)
        out["cp_batched_als"] = dict(
            index=list(range(len(kts))), results=[kt for kt, _ in fits], iters=[r.iters for _, r in fits],
            fits=[r.fit for _, r in fits], wall_s=wall, launches=counts,
            steps=sum(max(fits[i][1].iters for i in idx) for idx in groups.values()))
    return out


def path_diffs(a: dict, b: dict, x_norm: float | None = None) -> dict:
    """Two stress paths' largest |fit difference| and reconstruction
    difference (absolute, or relative to ``x_norm``) over the models ``b``
    ran (``a`` ran every model), and the models whose iteration counts
    differ, as (queue index, a's count, b's count)."""
    scale = 1.0 if x_norm is None else x_norm
    a_res, a_fits, a_iters = ([a[k][i] for i in b["index"]] for k in ("results", "fits", "iters"))
    rec = max(float(np.linalg.norm(dense(p) - dense(q))) / scale for p, q in zip(a_res, b["results"]))
    fit = max(abs(p - q) for p, q in zip(a_fits, b["fits"]))
    iters = [(i, p, q) for i, p, q in zip(b["index"], a_iters, b["iters"]) if p != q]
    return dict(max_fit_diff=fit, max_recon_diff=rec, iteration_mismatches=iters)


def stress_s1(dev) -> tuple:
    """S1: the slow lane's SimpleCorrectness at full size in float64 on
    ``dev`` (no kernel takes float64: the twostep and the unfused
    epilogue): cp_cals against cp_als on every STRESS_ALS_EVERY-th model
    and against cp_batched_als on every same-rank group, equal iteration
    counts, the reconstructions within STRESS_TOL."""
    x, ranks, kts = stress_workload()
    runs = stress_paths(x, ranks, kts, STRESS_ALS, dev, als_every=STRESS_ALS_EVERY)
    out = {p: {k: v for k, v in r.items() if k != "results"} for p, r in runs.items()}
    cals = runs["cp_cals"]
    index = runs["cp_als"]["index"]
    print(f"stress S1: the cp_als oracle on one model in {STRESS_ALS_EVERY}, queue indices {index[0]}, "
          f"{index[1]}, ..., {index[-1]} ({len(index)} of {len(kts)}; ranks {sorted(set(ranks[i] for i in index))}), "
          f"cut by index before any run for the phase's time budget", flush=True)
    for other in ("cp_als", "cp_batched_als"):
        d = out["cp_cals vs " + other] = path_diffs(cals, runs[other])
        print(f"stress S1 float64 cp_cals vs {other} ({len(runs[other]['index'])} models): "
              f"{len(d['iteration_mismatches'])} iteration mismatches (index, rank, cp_cals's, {other}'s) "
              f"{[(i, ranks[i], p, q) for i, p, q in d['iteration_mismatches']]}, "
              f"worst |reconstruction diff| {d['max_recon_diff']:.3e}", flush=True)
    print(f"stress S1 float64 ({len(kts)} models, buffer {STRESS_ENGINE['buffer_size']}): cp_cals "
          f"{cals['wall_s']:.3f}s, cp_als {runs['cp_als']['wall_s']:.3f}s, cp_batched_als "
          f"{runs['cp_batched_als']['wall_s']:.3f}s; churn {cals['churn']}, bucket-iterations "
          f"{cals['bucket_iterations']}, {cals['loop']['captures']} graph captures in {cals['capture_s']:.3f}s, "
          f"{cals['loop']['replays']} replays, {cals['loop']['stats_fetches']} stats fetches; mean iterations "
          f"{np.mean(cals['iters']):.2f} (from {min(cals['iters'])} to {max(cals['iters'])})", flush=True)
    for p, r in runs.items():
        if any(r["launches"].values()):
            raise AssertionError(f"stress S1 {p}: kernels launched in float64: {r['launches']}")
    for other in ("cp_als", "cp_batched_als"):
        d = out["cp_cals vs " + other]
        if d["iteration_mismatches"] or not d["max_recon_diff"] < STRESS_TOL:
            raise AssertionError(f"stress S1: cp_cals vs {other}: {d}")
    return x, ranks, kts, out


def s2_readings(runs: dict, ref: dict, x_norm: float) -> dict:
    """S2's differences: each float32 path against the float64 run, and the
    float32 paths against each other (relative to |X|)."""
    out = {p + " vs float64": path_diffs(runs[p], ref, x_norm) for p in runs}
    for i, p in enumerate(STRESS_PATHS):
        for q in STRESS_PATHS[i + 1:]:
            out[f"{p} vs {q}"] = path_diffs(runs[p], runs[q], x_norm)
    return out


def s3_reading(got, want, x_norm: float | None = None) -> float:
    """The largest difference of two jackknives' replicate reconstructions,
    each replicate without its left-out row (``jk_to_regular``): absolute,
    or relative to ``x_norm``."""
    from cp_cals_tpu_torch.ktensor import jk_to_regular

    scale = 1.0 if x_norm is None else x_norm
    worst = 0.0
    for reps_a, reps_b in zip(got.results, want.results):
        for f, (a, b) in enumerate(zip(reps_a, reps_b)):
            ra, rb = jk_to_regular(a, f), jk_to_regular(b, f)
            if not (np.isfinite(ra.factors[0]).all() and np.isfinite(rb.factors[0]).all()):
                raise AssertionError(f"stress S3: replicate {f} keeps a non-finite row after jk_to_regular")
            worst = max(worst, float(np.linalg.norm(dense(ra) - dense(rb))) / scale)
    return worst


def stress_phase(dev) -> dict:
    """S1, S2 and S3 on ``dev`` (module docstring, phase 6d); raises on any
    failure."""
    from cp_cals_tpu_torch import AlsParams, CalsParams, jk_cp_als, jk_cp_batched_als, jk_cp_cals

    t_phase = time.perf_counter()
    x, ranks, kts, out = stress_s1(dev)
    out = {"S1": out}

    # S2: float32 at "highest" with forced iterations, against the float64
    # run of the same settings on the card.
    highest = dict(precision="highest")
    ref = stress_paths(x, ranks, kts, STRESS_FORCED, dev, paths=("cp_cals",))["cp_cals"]
    x32, kts32 = as_float32(x, kts)
    runs = stress_paths(x32, ranks, kts32, STRESS_FORCED, dev, **highest)
    s2 = {p: {k: v for k, v in r.items() if k != "results"} for p, r in runs.items()}
    s2["float64 cp_cals"] = {k: v for k, v in ref.items() if k != "results"}
    s2["diffs"] = s2_readings(runs, ref, float(np.linalg.norm(x)))
    for p, r in runs.items():
        print(f"stress S2 float32 {p}: wall {r['wall_s']:.3f}s, launches {r['launches']}, {r['steps']} "
              f"iterations (bucket-iterations for cp_cals, every model's for cp_als, every group's for "
              f"cp_batched_als)", flush=True)
    for k, d in s2["diffs"].items():
        print(f"stress S2 {k}: max |fit diff| {d['max_fit_diff']:.3e}, max reconstruction diff / |X| "
              f"{d['max_recon_diff']:.3e}", flush=True)
    print(f"stress S2 float64 cp_cals (the reference): wall {ref['wall_s']:.3f}s; float32 cp_cals churn "
          f"{runs['cp_cals']['churn']}, {runs['cp_cals']['loop']['captures']} graph captures in "
          f"{runs['cp_cals']['capture_s']:.3f}s, {runs['cp_cals']['loop']['replays']} replays", flush=True)
    for p, r in runs.items():
        check_launches(f"stress S2 {p}", r["launches"], fused("highest"), r["steps"])
        if set(r["iters"]) != {STRESS_FORCED["max_iterations"]}:
            raise AssertionError(f"stress S2 {p}: iterations {set(r['iters'])}")
    for k, d in s2["diffs"].items():
        lim = STRESS_CROSS_TOL if k.endswith("float64") else tuple(2 * t for t in STRESS_CROSS_TOL)
        if not (d["max_fit_diff"] <= lim[0] and d["max_recon_diff"] <= lim[1]):
            raise AssertionError(f"stress S2 {k}: {d} beyond {lim}")
    out["S2"] = s2

    # S3: the jackknife at the reference's scale, float64 across the three
    # drivers, then float32 jk_cp_cals (the apply kernel's row zero).
    xj, fitted = jk_stress_problem(dev)
    engine = CalsParams(**JK_STRESS, **JK_STRESS_ENGINE, **pinned())
    als = AlsParams(**JK_STRESS)
    s3 = {}
    jk = {}
    for name, fn in (("jk_cp_cals", lambda: jk_cp_cals(xj, fitted, engine, device=dev)),
                     ("jk_cp_als", lambda: jk_cp_als(xj, fitted, als, device=dev)),
                     ("jk_cp_batched_als", lambda: jk_cp_batched_als(xj, fitted, als, device=dev))):
        jk[name], wall, counts = timed_call(dev, fn)
        s3[name] = dict(wall_s=wall, launches=counts)
        if any(counts.values()):
            raise AssertionError(f"stress S3 {name}: kernels launched in float64: {counts}")
    s3["float64 cp_cals vs cp_als"] = s3_reading(jk["jk_cp_cals"], jk["jk_cp_als"])
    s3["float64 cp_als vs cp_batched_als"] = s3_reading(jk["jk_cp_als"], jk["jk_cp_batched_als"])
    xj32, fitted32 = as_float32(xj, fitted)
    got, wall, counts = timed_call(dev, lambda: jk_cp_cals(
        xj32, fitted32, CalsParams(**JK_STRESS, **JK_STRESS_ENGINE, **highest, **pinned()), device=dev))
    rep = got.cals_report
    steps = sum(rep.engine_iterations.values())
    s3["float32 jk_cp_cals"] = dict(wall_s=wall, launches=counts, bucket_iterations=steps,
                                    loop=loop_totals(rep))
    s3["float32 vs float64"] = s3_reading(got, jk["jk_cp_cals"], float(np.linalg.norm(xj)))
    n_reps = sum(len(r) for r in got.results)
    walls = ", ".join(f"{k} {s3[k]['wall_s']:.3f}s" for k in jk)
    print(f"stress S3 ({len(fitted)} fitted rank-5 models, {n_reps} replicates, buffer "
          f"{JK_STRESS_ENGINE['buffer_size']}): float64 worst |reconstruction diff| cp_cals vs cp_als "
          f"{s3['float64 cp_cals vs cp_als']:.3e}, cp_als vs cp_batched_als "
          f"{s3['float64 cp_als vs cp_batched_als']:.3e}; walls {walls}; float32 jk_cp_cals at 'highest' "
          f"{wall:.3f}s, launches {counts}, {steps} bucket-iterations, against float64: max reconstruction "
          f"diff / |X| {s3['float32 vs float64']:.3e}", flush=True)
    check_launches("stress S3 float32 jk_cp_cals", counts, fused("highest"), steps)
    for k in ("float64 cp_cals vs cp_als", "float64 cp_als vs cp_batched_als"):
        if not s3[k] < STRESS_TOL:
            raise AssertionError(f"stress S3 {k}: {s3[k]:.3e}")
    if not s3["float32 vs float64"] <= JK_STRESS_CROSS_TOL:
        raise AssertionError(f"stress S3 float32 vs float64: {s3['float32 vs float64']:.3e}")
    out["S3"] = s3
    out["seconds"] = time.perf_counter() - t_phase
    print(f"stress phase: {out['seconds']:.1f}s", flush=True)
    return out


# ------------------------------------------------------------ studies phase
# The fidelity studies (cp_cals_tpu_torch/studies/) at full width, against
# the JAX package's committed float64 oracles (data/benchmarks/, run on the
# CPU).
STUDY_DIR = os.path.join("chiprun_out", "studies_phase")  # the studies' .npz bands of this run
STUDY_F64_FIT_TOL = 1e-9  # the port's float64 oracles on the card against JAX's: |fit difference|
STUDY_SE_TOL = 1e-6  # ... and the p99 over entries of |se - se64| / se64, per mode
# convergence_run's float32 configurations: "highest" and a "default"
# MTTKRP, both with a plain stop, and the "default" MTTKRP made tol-safe by
# the mixed-tier check and polished. The plain-stop "default" is known to
# stop on the bf16 tier's noise: printed, not bounded.
STUDY_CONV = {
    "highest": {},
    "default": dict(mttkrp_precision="default"),
    "default mixed": dict(mttkrp_precision="default", tol_check=5, polish=2),
}
STUDY_JK_TIERS = ("high", "high_xla", "default_polish_conv")
# The float32 readings' limits, from the port's float32 CPU runs of the same
# legs (tools/study_bounds.py, the kernels' plain versions, 6 threads)
# against the committed oracles: each is the CPU reading times 10, rounded
# up to one significant digit, for the card's other summation orders (the
# stress phase's precedent). The CPU read: convergence "highest" 2.878e-6,
# "default mixed" 2.045e-6; SE p99 by mode f32_high and f32_high_xla
# 0.028 / 0.079 / 0.382 (the plain versions of the fused and the unfused
# epilogue are one computation on the CPU), f32_default_polish_conv 5.93 /
# 6.36 / 20.87; bench_tol median 1.876e-6, p99 9.547e-5; the external row
# 2.342e-5. bench_tol's largest delta and its count of deltas above 1e-2
# are printed with each such model's direction, not bounded: a landing in
# another local minimum is a discrete event of a tol-driven float32
# trajectory (on the CPU model 82, rank 5, fits 0.9501 against float64's
# 0.5796: the float32 run found the better basin), which the p99 of 400
# models does not see.
STUDY_BOUNDS = {
    "convergence highest": {"max_abs_fit_delta": 3e-5},
    "convergence default mixed": {"max_abs_fit_delta": 3e-5},
    "jk f32_high": {"dtype_err_over_scatter_p99": [0.3, 0.8, 4.0]},
    "jk f32_high_xla": {"dtype_err_over_scatter_p99": [0.3, 0.8, 4.0]},
    "jk f32_default_polish_conv": {"dtype_err_over_scatter_p99": [60.0, 70.0, 300.0]},
    "bench_tol": {"median_abs_fit_delta_vs_f64": 2e-5, "p99_abs_fit_delta_vs_f64": 1e-3},
    "external_cpd": {"max_abs_fit_diff_vs_torch": 3e-4},
}


def study_models(rep) -> list:
    return [{"id": m.id, "rank": m.rank, "iters": m.iters, "fit": float(m.fit)} for m in rep.models]


def oracle_partings(name: str, models: list, oracle: list) -> dict:
    """A float64 run's models against a committed oracle's, by id: the
    models whose iteration counts differ (id, rank, the port's, JAX's)
    and the largest |fit difference|."""
    om = {m["id"]: m for m in oracle}
    if set(om) != {m["id"] for m in models}:
        raise AssertionError(f"{name}: the run's model ids differ from the committed oracle's")
    mism = [(m["id"], m["rank"], m["iters"], om[m["id"]]["iters"]) for m in models if m["iters"] != om[m["id"]]["iters"]]
    fit = max(abs(m["fit"] - om[m["id"]]["fit"]) for m in models)
    return dict(n_models=len(models), iteration_mismatches=mism, max_fit_diff=fit)


def check_partings(name: str, d: dict) -> None:
    if d["iteration_mismatches"] or not d["max_fit_diff"] <= STUDY_F64_FIT_TOL:
        raise AssertionError(f"studies {name}: float64 against the committed oracle: {d}")


def study_f64(dev) -> dict:
    """The three float64 oracles on ``dev``, each against the committed one
    (module docstring, phase 6e); raises on any failure."""
    from cp_cals_tpu_torch.studies import bench_tol as bt
    from cp_cals_tpu_torch.studies import convergence_run as cr
    from cp_cals_tpu_torch.studies import jk_fidelity_study as jk
    from cp_cals_tpu_torch.studies._common import committed_oracle

    out = {}
    x64, q64 = cr.workload()
    (_, rep, _), wall, counts = timed_call(
        dev, lambda: cr.run(x64, q64, cr.params(**pinned()), torch.float64, dev, warm=False))
    out["convergence"] = dict(wall_s=wall, launches=counts, **oracle_partings(
        "convergence", study_models(rep), committed_oracle("convergence_f64.json")["models"]))
    r, wall, counts = timed_call(dev, lambda: jk.run(torch.float64, "f64", device=dev, out_dir=STUDY_DIR, **pinned()))
    se64 = committed_oracle("jk_fidelity_f64.npz")
    p99 = [float(np.quantile(np.abs(b - se64[f"se{m}"]) / np.maximum(se64[f"se{m}"], 1e-12), 0.99))
           for m, b in enumerate(r["bands"])]
    iters = [m.iters for m in r["report"].cals_report.models]
    out["jk_fidelity"] = dict(wall_s=wall, launches=counts, n_replicates=len(iters), se_rel_p99=p99,
                              iters=[min(iters), max(iters)])
    x_np, specs = bt.workload()
    o, wall, counts = timed_call(dev, lambda: bt.run_oracle(x_np, specs, bt.oracle_params(**pinned()), dev))
    out["bench_tol"] = dict(wall_s=wall, engine_s=o["wall_s"], launches=counts, **oracle_partings(
        "bench_tol", o["models"], committed_oracle("bench_tol_f64.json")["models"]))
    out["bench_tol"]["model_iterations"] = sum(m["iters"] for m in o["models"])
    for name in ("convergence", "bench_tol"):
        d = out[name]
        print(f"studies float64 {name} on {dev.type} vs the committed JAX oracle: {d['n_models']} models, "
              f"{len(d['iteration_mismatches'])} iteration mismatches (id, rank, port's, JAX's) "
              f"{d['iteration_mismatches']}, max |fit diff| {d['max_fit_diff']:.3e}; wall {d['wall_s']:.3f}s", flush=True)
    d = out["jk_fidelity"]
    print(f"studies float64 jk_fidelity on {dev.type}: {d['n_replicates']} replicates ({d['iters'][0]} to "
          f"{d['iters'][1]} iterations), p99 |se - se64| / se64 by mode vs the committed bands "
          f"{[f'{v:.3e}' for v in p99]}; wall {d['wall_s']:.3f}s", flush=True)
    for name, d in out.items():
        if any(d["launches"].values()):
            raise AssertionError(f"studies float64 {name}: kernels launched in float64: {d['launches']}")
    check_partings("convergence", out["convergence"])
    check_partings("bench_tol", out["bench_tol"])
    if not max(p99) <= STUDY_SE_TOL:
        raise AssertionError(f"studies float64 jk_fidelity: SE bands against the committed ones: {p99}")
    return out


def study_launch_check(name: str, params, rep, counts: dict, routes: dict, card: bool) -> None:
    """A study run with the MTTKRP pinned to the fused kernels: 3 MTTKRP
    launches per bucket-iteration at the fast tier and per polish sweep at
    ``precision``, the mixed-tier check's once per bucket-iteration as a
    predicated launch, the fused epilogue 3 x (bucket-iterations + polish
    sweeps) unless the run takes the unfused one (``table_counts`` of
    all-fused picks); the MTTKRP results by route to match. Off the
    ``card`` (where no launch is counted) the routes alone."""
    picks = {r: (("pallas",) * 3, None) for r in rep.engine_iterations}
    kernels, predicated, want_routes = table_counts(picks, rep, params, 3, epilogue=params.epilogue != "xla")
    if card:
        # A tier with no polish sweeps (or no check) launches none of its kernel.
        check_counts(name, counts, {k: v for k, v in kernels.items() if v}, predicated)
    check_route_counts(name, routes, want_routes)


def study_fp32(dev) -> dict:
    """The float32 legs of the studies on ``dev`` (module docstring, phase
    6e), each reading against the committed float64 oracle. On the CPU
    (tools/study_bounds.py) the runs' routes are checked and their readings
    made, without the untimed warm runs."""
    from cp_cals_tpu_torch import cp_cals, launches
    from cp_cals_tpu_torch.solvers.cals import precompile_buckets
    from cp_cals_tpu_torch.studies import bench_external_cpd as be
    from cp_cals_tpu_torch.studies import bench_tol as bt
    from cp_cals_tpu_torch.studies import convergence_run as cr
    from cp_cals_tpu_torch.studies import jk_fidelity_study as jk
    from cp_cals_tpu_torch.studies._common import committed_oracle

    card = dev.type == "cuda"
    out = {}

    def counted(name, params, fn, rep_of):
        got, wall, counts = timed_call(dev, fn)
        routes = launches.routes()
        rep = rep_of(got)
        study_launch_check(f"studies {name}", params, rep, counts, routes, card)
        steps = sum(rep.engine_iterations.values())
        out[name] = dict(wall_s=wall, launches=counts, routes=routes, bucket_iterations=steps,
                         polish_sweeps=loop_totals(rep)["polish_sweeps"])
        return got

    x64, q64 = cr.workload()
    conv64 = committed_oracle("convergence_f64.json")["models"]
    for tag, kw in STUDY_CONV.items():
        params = cr.params(**kw, **pinned())
        if card:
            cr.run(x64, q64, params, torch.float32, dev, warm=False)
        _, rep, _ = counted(f"convergence {tag}", params,
                            lambda: cr.run(x64, q64, params, torch.float32, dev, warm=False), lambda g: g[1])
        models = study_models(rep)
        out[f"convergence {tag}"].update(cr.compare(models, conv64), iters=[m["iters"] for m in models])

    se64 = committed_oracle("jk_fidelity_f64.npz")
    bands = {}
    for tier in STUDY_JK_TIERS:
        tag = jk.tag_of(False, tier)
        params = jk.tier_params(tier, **pinned())
        r = counted(f"jk {tag}", params, lambda: jk.run(torch.float32, tag, tier, device=dev, out_dir=STUDY_DIR,
                                                        **pinned()),
                    lambda g: g["report"].cals_report)
        bands[tag] = {f"se{m}": b for m, b in enumerate(r["bands"])}
        iters = [m.iters for m in r["report"].cals_report.models]
        out[f"jk {tag}"].update(mean_iters=float(np.mean(iters)), engine_s=r["wall_s"])
    for tag, rows in jk.compare_bands(se64, bands).items():
        out[f"jk {tag}"]["rows"] = rows
        out[f"jk {tag}"]["dtype_err_over_scatter_p99"] = [row["dtype_err_over_scatter_p99"] for row in rows]

    x_np, specs = bt.workload()
    params = bt.card_params(environ={}, **pinned())
    if card:
        xq = torch.from_numpy(x_np.astype(np.float32)).to(dev)
        precompile_buckets(xq, specs, params, device=dev)
        cp_cals(xq, specs, params, device=dev)
    _, rep, wall = counted("bench_tol", params, lambda: bt.run_card(x_np, specs, params, 1, dev, warm=False),
                           lambda g: g[1])
    models = [{"id": m.id, "rank": m.rank, "fit": m.fit, "iters": m.iters} for m in rep.models]
    out["bench_tol"].update(bt.compare(models, committed_oracle("bench_tol_f64.json")["models"], bt.MODES, wall),
                            engine_s=wall, models_per_sec=len(specs) / wall,
                            mean_iters=float(np.mean([m["iters"] for m in models])))

    x, inits = be.build_workload()
    ref_fits = committed_oracle("external_cpd.json")["contenders"]["torch_cpu_fp64"]["fits"]
    params = be.card_params(**pinned())
    if card:
        xq = torch.from_numpy(x.astype(np.float32)).to(dev)
        queue = be.queue_at(inits, np.float32)
        precompile_buckets(xq, queue, params, device=dev)
        cp_cals(xq, queue, params, device=dev)
    row = counted("external_cpd", params, lambda: be.card_row(x, inits, ref_fits, dev, reps=1, warm=False, **pinned()),
                  lambda g: g["report"])
    out["external_cpd"].update({k: v for k, v in row.items() if k not in ("report", "device")}, engine_s=row["wall_s"])
    return out


def study_lines(fp32: dict) -> None:
    for name, d in fp32.items():
        if name.startswith("convergence"):
            what = (f"max |fit delta| {d['max_abs_fit_delta']:.3e}, mean {d['mean_abs_fit_delta']:.3e}, iteration "
                    f"ratio mean {d['mean_iters_ratio_vs_f64']:.3f} max {d['max_iters_ratio_vs_f64']:.3f}, "
                    f"iterations {d['iters']}")
        elif name.startswith("jk"):
            what = (f"dtype_err_over_scatter_p99 by mode {[f'{v:.3f}' for v in d['dtype_err_over_scatter_p99']]}, "
                    f"mean iterations {d['mean_iters']:.2f}")
        elif name == "bench_tol":
            what = (f"{d['models_per_sec']:.1f} models/s, |fit delta| median {d['median_abs_fit_delta_vs_f64']:.3e} "
                    f"p99 {d['p99_abs_fit_delta_vs_f64']:.3e} max {d['max_abs_fit_delta_vs_f64']:.3e}, "
                    f"n_delta_gt_1e-2 {d['n_delta_gt_1e-2']}, iteration ratio mean "
                    f"{d['mean_iters_ratio_vs_f64']:.3f} max {d['max_iters_ratio_vs_f64']:.3f}, vs_baseline "
                    f"{d['vs_baseline']:.3f}; beyond 1e-2 (id, rank, fit, float64 fit) "
                    f"{[(w['id'], w['rank'], w['fit'], w['fit_f64']) for w in d['worst_models'] if w['delta'] > 1e-2]}")
        else:
            what = f"{d['models_per_sec']:.1f} models/s, max |fit diff| vs torch float64 {d['max_abs_fit_diff_vs_torch']:.3e}"
        print(f"studies float32 {name}: {what}; wall {d['wall_s']:.3f}s, {d['bucket_iterations']} bucket-iterations, "
              f"{d['polish_sweeps']} polish sweeps, launches {d['launches']}", flush=True)


def check_study_bounds(fp32: dict) -> None:
    for name, limits in STUDY_BOUNDS.items():
        for key, lim in limits.items():
            got = fp32[name][key]
            pairs = zip(got, lim) if isinstance(got, list) else [(got, lim)]
            if not all(v <= w for v, w in pairs):
                raise AssertionError(f"studies {name}: {key} {got} beyond {lim}")


def studies_phase(dev) -> dict:
    """The fidelity studies on ``dev`` (module docstring, phase 6e); raises
    on any failure."""
    from cp_cals_tpu_torch.studies import jk_fidelity_study as jk

    t_phase = time.perf_counter()
    out = {"float64": study_f64(dev)}
    fp32 = study_fp32(dev)
    study_lines(fp32)
    print("studies jk compare (dtype_err_over_scatter_p99 by mode): " + "; ".join(
        f"{jk.tag_of(False, t)} {[round(v, 3) for v in fp32['jk ' + jk.tag_of(False, t)]['dtype_err_over_scatter_p99']]}"
        for t in STUDY_JK_TIERS), flush=True)
    out["float32"] = fp32
    check_study_bounds(fp32)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"studies phase: {out['seconds']:.1f}s", flush=True)
    return out


# ------------------------------------------------------------ profiles (6f)

PROFILE_REPS = 2  # timed replays of each body in the phase (the scripts' 3 to 7)
PROFILE_TUNE_LOOP = 20  # chained steps per replay of the plan sweep (its command line: 100)
# The runs of the phase (module, its arguments) and the kernels each
# launches on the card, each at least once; no other kernel may launch.
PROFILE_RUNS = {
    "profile_iteration": (["--components", "--precisions", "highest,high,default", "--reps", str(PROFILE_REPS)],
                          ("fused_mttkrp_tc", "normal_inverse", "epilogue_apply")),
    "profile_ablation": (["--reps", str(PROFILE_REPS)], ()),
    "profile_epilogue_ab": (["--reps", str(PROFILE_REPS)], ("fused_mttkrp_tc", "normal_inverse", "epilogue_apply")),
    "profile_update_variants": (["--reps", str(PROFILE_REPS)], ("spd_inverse",)),
    "bench_pallas_ab": (["20", "96", "3", "high"], ("fused_mttkrp_tc",)),
    "tune_pallas_mttkrp": (["--precisions", "highest,high,default", "--reps", "3", "--n-loop",
                            str(PROFILE_TUNE_LOOP)], ("fused_mttkrp_fp32", "fused_mttkrp_tc")),
}


def profiles_phase(dev) -> dict:
    """The component profiles and kernel A/Bs (cp_cals_tpu_torch/profiles/)
    on ``dev`` at the scripts' widths (module docstring, phase 6f); raises
    on any failure. Each profile holds every kernel it launches against
    the plain version on the same inputs before it times it (its readings
    in ``checks``), and writes its JSON to chiprun_out/profiles/. Each run
    starts with the launch counts at 0 (replays counted): the kernels of
    PROFILE_RUNS each launch, no other does, and bench_pallas_ab's fused
    kernel exactly (check + warm-up + (1 + reps) replays of N_LOOP) per
    mode."""
    import importlib

    t_phase = time.perf_counter()
    out = {}
    for name, (argv, kernels) in PROFILE_RUNS.items():
        mod = importlib.import_module(f"cp_cals_tpu_torch.profiles.{name}")
        args = mod.parser().parse_args(argv + ["--device", dev.type])
        checks = {}
        run = (lambda: mod.run(args)) if name == "profile_ablation" else (lambda: mod.run(args, checks))
        res, wall, counts = timed_call(dev, run)
        if dev.type == "cuda":
            for k, v in counts.items():
                if (k in kernels) != (v > 0):
                    raise AssertionError(f"profiles {name}: {k} launched {v} times; expected launches of {kernels}")
            if name == "bench_pallas_ab":
                want = 3 * (2 + (1 + args.reps) * mod.N_LOOP)
                if counts["fused_mttkrp_tc"] != want:
                    raise AssertionError(f"profiles bench_pallas_ab: {counts['fused_mttkrp_tc']} launches, "
                                         f"expected {want}")
        out[name] = dict(result=res, checks=checks, launches=counts, wall_s=wall)
        print(f"profiles {name}: {wall:.1f}s, launches {({k: v for k, v in counts.items() if v})}", flush=True)
    ab = out["profile_epilogue_ab"]["result"]
    print(f"profiles: iteration fused {ab['iteration_fused_ms']} ms, xla {ab['iteration_xla_ms']} ms per step "
          f"(B=96, R=20, 'high')", flush=True)
    for row in out["tune_pallas_mttkrp"]["result"]["summary"]:
        print(f"profiles tune m{row['mode']} {row['tier']}: twostep {row['twostep_ms']}, planner "
              f"{row['planner_name']} {row['planner_ms']}, best {row['best_name']} {row['best_ms']} (ms)", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"profiles phase: {out['seconds']:.1f}s", flush=True)
    return out


# ------------------------------------------------------ the last scripts (6g)

SCRIPTS_DIR = os.path.join("chiprun_out", "scripts_phase")  # the phase's JSON files and figures
SCRIPTS_LUT_ROOT = os.path.join("build", "chip_smoke_lut_grid")  # the grid tuner's scratch tables, removed after
# The external study cut for the phase: the bench tensor, two of the
# script's three ranks, one timed rep.
SCRIPTS_EXTERNAL = ["--tensors", "299-301-41", "--ranks", "5,20", "--reps", "1"]
# The grid tuner at the bench workload's queue, buckets and budget.
SCRIPTS_LUT = ["-t", "299-301-41", "--ranks", "1:20:20", "--buckets", "4,8,12,16,20", "--buffer", str(BUFFER),
               "--precision", "default"]


def external_check(summary: dict, counts: dict, reps: int, card: bool = True) -> dict:
    """The external study's rows: every float64 contender within its 1e-10
    of the oracle, and on the ``card`` each fused kernel launched exactly
    (1 + reps) times per (mode, rank) its gate takes (the timing's warm-up
    and timed reps; the check against the plain version reads the last
    rep's result), no other kernel at all. Returns the launches and the
    gate's refusals."""
    from cp_cals_tpu_torch.studies import bench_mttkrp_external as ext

    want = dict.fromkeys(counts, 0)
    refused = []
    for row in summary["rows"]:
        for name, rel in row["vs_oracle"].items():
            if not rel <= ext.TOL:
                raise AssertionError(f"scripts external {name}: {rel:g} from the oracle at {row['tensor']} rank "
                                     f"{row['rank']} mode {row['mode']}")
        for tier, kernel in ext.FUSED_TIERS.items():
            gate = row.get(f"ours_fused_{tier}_gate")
            if gate is None and not card:
                continue  # the float32 rows run on the card only
            if gate == "refused":
                refused.append((row["tensor"], row["rank"], row["mode"], tier))
                continue
            if row[f"ours_fused_{tier}_launches"] != 1 + reps:
                raise AssertionError(f"scripts external {kernel}: {row[f'ours_fused_{tier}_launches']} launches in "
                                     f"a row, expected {1 + reps}")
            want[kernel] += 1 + reps
    if counts != want:
        raise AssertionError(f"scripts external: launches {counts}, expected {want}")
    return dict(launches=counts, refused=refused)


def lut_grid_check(res: dict, dev) -> None:
    """The grid tuner into an empty root: no exact lookup before, every
    lookup exact after, every pick one the fused gate takes."""
    from cp_cals_tpu_torch.ops.fused_mttkrp import fused_mttkrp_supported

    n = 3 * len(res["programs"])
    if res["lookup_stats_before"]["exact"] or res["lookup_stats_after"] != {"exact": n, "nearest": 0,
                                                                            "heuristic": 0}:
        raise AssertionError(f"scripts lut grid: lookups before {res['lookup_stats_before']}, after "
                             f"{res['lookup_stats_after']}; {n} exact expected after")
    for key, methods in res["programs"].items():
        b, r = (int(v) for v in key.split("x"))
        for mode, m in enumerate(methods):
            if m == "pallas" and not fused_mttkrp_supported(tuple(res["modes"]), mode, b, r, torch.float32, dev):
                raise AssertionError(f"scripts lut grid {key} mode {mode}: 'pallas' where the gate refuses")


def scripts_phase(dev) -> dict:
    """The last of the JAX package's scripts on ``dev`` (module docstring,
    phase 6g): the external MTTKRP study, the grid tuner, the layout-policy
    A/B and the figures, each at a cut size; raises on any failure."""
    import importlib.util
    import shutil

    from cp_cals_tpu_torch import plot_experiments
    from cp_cals_tpu_torch.profiles import tune_lut_grid
    from cp_cals_tpu_torch.studies import bench_mttkrp_external as ext

    t_phase = time.perf_counter()
    shutil.rmtree(SCRIPTS_DIR, ignore_errors=True)
    out = {}

    reps = int(SCRIPTS_EXTERNAL[SCRIPTS_EXTERNAL.index("--reps") + 1])
    summary, wall, counts = timed_call(dev, lambda: ext.main(SCRIPTS_EXTERNAL + ["--device", dev.type, "--out",
                                                                                SCRIPTS_DIR]))
    out["external"] = dict(external_check(summary, counts, reps, dev.type == "cuda"), wall_s=wall,
                           rows=summary["rows"])
    print(f"scripts external: {len(summary['rows'])} rows in {wall:.1f}s, launches "
          f"{({k: v for k, v in counts.items() if v})}, refused by the gate {out['external']['refused']}", flush=True)

    shutil.rmtree(SCRIPTS_LUT_ROOT, ignore_errors=True)
    try:
        args = tune_lut_grid.parser().parse_args(SCRIPTS_LUT + ["--tables", SCRIPTS_LUT_ROOT, "--device", dev.type,
                                                               "--out", SCRIPTS_DIR])
        res, wall, _ = timed_call(dev, lambda: tune_lut_grid.run(args))
    finally:
        shutil.rmtree(SCRIPTS_LUT_ROOT, ignore_errors=True)
    lut_grid_check(res, dev)
    out["lut_grid"] = dict(res, wall_s=wall)
    print(f"scripts lut grid: {len(res['programs'])} programs in {wall:.1f}s; lookups before "
          f"{res['lookup_stats_before']}, after {res['lookup_stats_after']}", flush=True)

    lab = tool("layout_policy_ab")
    t0 = time.perf_counter()
    with EngineRuns() as runs:
        ab, _ = lab.ab(EXP_SWEEP["modes"], EXP_SWEEP["copies"], EXP_SWEEP["max_iter"], turns=1, device=dev)
    if runs.autotunes:
        raise AssertionError(f"scripts layout A/B: {runs.autotunes} autotunes (a table misses)")
    for policy in lab.POLICIES:
        if ab[policy]["mode_layouts_resolved"] != policy:
            raise AssertionError(f"scripts layout A/B: {policy} resolved to {ab[policy]['mode_layouts_resolved']}")
        if dev.type == "cuda" and "hbm_measured" not in ab[policy]:
            raise AssertionError(f"scripts layout A/B {policy}: no hbm_measured on the card")
    os.makedirs(SCRIPTS_DIR, exist_ok=True)
    with open(os.path.join(SCRIPTS_DIR, "scale_sweep_layout_policy.json"), "w") as fh:
        json.dump(ab, fh, indent=1)
    out["layout_ab"] = dict(ab, wall_s=time.perf_counter() - t0, runs=runs.runs)

    def peak(p):
        m = ab[p].get("hbm_measured")
        return "not measured" if m is None else f"{m['peak_bytes_in_use'] / 1e9:.3f} GB"

    print("scripts layout A/B at " + "x".join(map(str, EXP_SWEEP["modes"])) + f", {EXP_SWEEP['copies']} copies, "
          f"{EXP_SWEEP['max_iter']} iterations: " + "; ".join(
              f"{p} {ab[p]['models_per_sec']} models/s, {ab[p]['mttkrp_tflops']} TFLOP/s, peak {peak(p)} (reckoned "
              f"{(ab[p]['hbm_reckoned']['tensor'] + ab[p]['hbm_reckoned']['held_layouts']) / 1e9:.3f} GB)"
              for p in lab.POLICIES) + f"; checks {ab['checks']}", flush=True)

    profiles_dir = os.path.join("chiprun_out", "profiles")
    drawn = plot_experiments.main(["--data", EXP_DIR, "--profiles", profiles_dir, "--out",
                                   os.path.join(SCRIPTS_DIR, "figures")])
    if importlib.util.find_spec("matplotlib") is None:
        print(plot_experiments.SKIP_LINE, flush=True)
    else:
        want = set()
        if os.path.exists(os.path.join(EXP_DIR, "experiments.json")):
            want |= {"speedup.png", "jk_scale.png", "defrag.png"}
        if os.path.exists(os.path.join(EXP_DIR, "convergence_cuda.json")):
            want.add("convergence.png")
        if os.path.exists(os.path.join(profiles_dir, "profile.json")):
            want |= {"mttkrp_methods.png", "roofline.png"}
        got = {os.path.basename(p) for p in drawn}
        if got != want or any(os.path.getsize(p) == 0 for p in drawn):
            raise AssertionError(f"scripts figures: drew {sorted(got)}, expected {sorted(want)}, each non-empty")
    out["figures"] = [os.path.basename(p) for p in drawn]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scripts phase: {out['seconds']:.1f}s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from cp_cals_tpu_torch import _build

    t_run = time.perf_counter()
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
    table = table_phase(dev)

    queue = engine_queue(rng)
    engine_run(x_np, queue[::80], {}, "warm-up", check_fit=False, **pinned())
    res_a, rep_a, run_a = engine_run(x_np, queue, {}, "highest")
    res_b, rep_b, run_b = engine_run(x_np, queue, BENCH_TIERS, "bench-tiers")
    res_i, rep_i, run_i = engine_run(x_np, queue, BENCH_TIERS, "bench-tiers iter", sync_mode="iter")
    assert_bit_identical("bench-tiers graph loop vs sync_mode='iter'", (res_b, rep_b), (res_i, rep_i))
    res_h, rep_h, run_h = engine_run(x_np, queue, BENCH_TIERS, "headline", **HEADLINE)
    check = cross_check(x_np, queue, {"highest": (res_a, rep_a), "bench-tiers": (res_b, rep_b)}, picks_of(run_a))
    check.update(cross_check(x_np, queue, {"headline": (res_h, rep_h)}, picks_of(run_h), **HEADLINE))
    threads = bucket_threads_phase(x_np, queue)

    # The other MTTKRP routes, the layout policies and the dimension tree on
    # the bench tensor (3-D), each checked.
    from cp_cals_tpu_torch import MttkrpMethod

    res_t, rep_t, run_t = engine_run(x_np, queue, {}, "twostep", per_step=fused("highest", mttkrp_modes=0),
                                     routes={"twostep": 3}, mttkrp_method=MttkrpMethod.TWOSTEP)
    res_k, rep_k, run_k = engine_run(x_np, queue, {}, "krp_gemm", per_step=fused("highest", mttkrp_modes=0),
                                     routes={"krp_gemm": 3}, mttkrp_method=MttkrpMethod.KRP_GEMM)
    res_r, rep_r, run_r = engine_run(x_np, queue, BENCH_TIERS, "bench-tiers recompute", mode_layouts="recompute")
    assert_bit_identical("bench-tiers mode_layouts='recompute' vs 'materialized'", (res_b, rep_b), (res_r, rep_r))
    # dimtree="on" at "highest" beside "off", in turns: off, on, on, off.
    dimtree = dict(per_step=fused("highest", mttkrp_modes=1), routes={"fused": 1, "dimtree": 2}, dimtree="on",
                   **pinned())
    res_d, rep_d, run_d = engine_run(x_np, queue, {}, "dimtree", **dimtree)
    run_d2 = engine_run(x_np, queue, {}, "dimtree again", **dimtree)[2]
    run_a2 = engine_run(x_np, queue, {}, "highest again")[2]
    dimtree_walls = dict(off=[run_a["wall_s"], run_a2["wall_s"]], on=[run_d["wall_s"], run_d2["wall_s"]])
    print(f"dimtree at 'highest': walls off {dimtree_walls['off']}, on {dimtree_walls['on']} (s, in the order "
          f"off, on, on, off)", flush=True)
    check.update(cross_check(x_np, queue, {"twostep": (res_t, rep_t), "krp_gemm": (res_k, rep_k),
                                           "dimtree": (res_d, rep_d)}))
    f64 = f64_phase()
    nd = nd_phase(dev)
    wide = widened_phase(dev)
    nnls = nnls_phase()
    ls = line_search_phase(x_np, queue)

    kt5, fit5 = fit_jk_model(x_np)
    jk_runs, rec, j1_rec = jk_phase(x_np, kt5)
    j1_mix = mttkrp_mix(j1_rec, x)
    spd = spd_phase(rec, dev)
    jk_check = jk_cross_check(x_np, kt5)
    jk_check.update(j4_stop_check(x_np, kt5))
    multi = mesh_phase(x_np, kt5, res_a, rep_a, run_a, res_b, rep_b, run_b)
    jk_ls = jk_line_search_phase(x_np, kt5)
    debug = debug_phase()
    entry_pts = entry_point_phase(x_np, dev)
    exps = experiments_phase(dev)
    stress = stress_phase(dev)
    studies = studies_phase(dev)
    profiles = profiles_phase(dev)
    scripts = scripts_phase(dev)
    cube500_mix = cube500_mttkrp_phase(dev)
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f}s so far", flush=True)
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
        w = fused_weights(run, rep) if key == "mttkrp" else rep.engine_iterations

        def mean(field, t=t, key=key, w=w):
            return weighted(rows, w, key, field, t)

        err = (max(row[key][t]["max_abs_err"] for row in rows) if key == "mttkrp" else worst[key])
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=run["launches"][name], max_abs_err=err,
            ms=mean("ms"), graph_ms=mean("graph_ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by="operations" if mean("bound_ops_ms") >= mean("bound_bytes_ms") else "bytes",
            library_ms=None if key == "apply" else mean("library_ms"),
            library_graph_ms=(None if key == "apply" else read_mean(rows, w, key, "library_graph_ms") if key == "hinv"
                              else mean_or_none(rows, w, key, "library_graph_ms", t)),
        )
        if key == "mttkrp":
            entry["tier"] = t
        if name == "fused_mttkrp_fp32":
            print(f"fused_mttkrp_fp32 at the highest engine's mix: {entry['ms']:.4f}ms eager, "
                  f"{entry['graph_ms']:.4f}ms graph-replayed; torch twostep {entry['library_ms']:.4f}ms eager, "
                  f"{entry['library_graph_ms']:.4f}ms graph-replayed; bound {entry['bound_ms']:.4f}ms", flush=True)
        if name == "epilogue_apply":
            entry["max_err_rel"] = worst["apply_err"]
        if name == "fused_mttkrp_tc":
            entry["max_abs_err"] = max(err, *(m["max_abs_err"] for m in j1_mix + nnls["mttkrp_mix"]))
            entry["by_tier"] = {tt: {f: mean_or_none(rows, w, key, f, tt) for f in
                                     ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms")}
                                for tt in ("default", "high")}
            entry["j1_mix"], entry["nnls_mix"] = mix_summary(j1_mix), mix_summary(nnls["mttkrp_mix"])
        # The README command's launch mixes, and its --fast run's.
        for run_name in ("readme_cli", "fast_cli"):
            mix = entry_pts[run_name]["mixes"].get(name)
            if mix:
                entry[run_name + "_mix"] = mix_summary(mix)
                entry["max_abs_err"] = max(entry["max_abs_err"], entry[run_name + "_mix"]["max_abs_err"])
        # Each rank's launches in the multi-device phase's runs.
        entry["multi_device_launches"] = {run: [r["launches"][name] for r in v["ranks"]]
                                          for run, v in multi["runs"].items()}
        kernels.append(entry)
    # The widened epilogue kernels at K = 3 (the 4-D run's normal matrices
    # and FastALS error), at that run's launch mix.
    run4 = nd["4-D bench-tiers"]
    w4 = run4["bucket_iterations"]
    for name, key, replaces in (
            ("normal_inverse_k3", "hinv", "cp_cals_tpu/ops/pallas_epilogue.py:63"),
            ("epilogue_apply_k3", "apply", "cp_cals_tpu/ops/pallas_epilogue.py:186")):
        k3 = wide["rows"][3]

        def mean(field, key=key, k3=k3):
            return weighted(k3, w4, key, field)

        kernels.append(dict(
            name=name, route="cuda", source="cp_cals_tpu_torch/csrc/fused_epilogue.cu", replaces=replaces,
            launches=run4["launches"][name[:-3]], max_abs_err=max(row[key]["max_abs_err"] for row in k3),
            ms=mean("ms"), graph_ms=mean("graph_ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by="operations" if mean("bound_ops_ms") >= mean("bound_bytes_ms") else "bytes",
            library_ms=mean("library_ms") if key == "hinv" else None,
            library_graph_ms=read_mean(k3, w4, key, "library_graph_ms") if key == "hinv" else None, k=3,
        ))
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
            library_graph_ms=None if any(m["library_graph_ms"] is None for m in mix) else mean("library_graph_ms"),
        ))

    # Each kernel's launches in the experiment harness's engine runs, by
    # run, and in the stress phase's float32 runs, by path.
    for entry in kernels:
        entry["experiments_launches"] = exps["launches_by_label"].get(entry["name"], {})
        entry["stress_launches"] = {f"S2 {p}": stress["S2"][p]["launches"].get(entry["name"], 0)
                                    for p in STRESS_PATHS}
        entry["stress_launches"]["S3 jk_cp_cals"] = stress["S3"]["float32 jk_cp_cals"]["launches"].get(
            entry["name"], 0)
        entry["study_launches"] = {}
        for leg, d in studies["float32"].items():
            entry["study_launches"][leg] = d["launches"].get(entry["name"], 0)
            if d["launches"].get(entry["name"] + ".predicated"):
                entry["study_launches"][leg + " (predicated)"] = d["launches"][entry["name"] + ".predicated"]
        entry["profile_launches"] = {name: d["launches"].get(entry["name"], 0)
                                     for name, d in profiles.items() if name != "seconds"}
        entry["scripts_launches"] = scripts["external"]["launches"].get(entry["name"], 0)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, shapes=rows, table=table,
                       engine={"highest": run_a, "bench_tiers": run_b, "bench_tiers_iter": run_i,
                               "headline": run_h}, bucket_threads=threads,
                       other_routes={"twostep": run_t, "krp_gemm": run_k, "bench_tiers_recompute": run_r,
                                     "dimtree": run_d, "dimtree_walls": dimtree_walls},
                       float64_on_card=f64, nd=nd, widened=wide,
                       cross_check=check, cp_als=fit5, jackknife=jk_runs, jk_cross_check=jk_check,
                       multi_device=multi,
                       mttkrp_j1_mix=j1_mix, mttkrp_cube500=cube500_mix, nnls=nnls, line_search=ls,
                       jk_line_search=jk_ls, debug=debug,
                       entry_points=entry_pts, experiments=exps, stress=stress, studies=studies, profiles=profiles,
                       scripts=scripts, spd_inverse=spd, probe=probe, kernels=kernels), fh, indent=1, default=str)
    print(f"chip_smoke: whole run {time.perf_counter() - t_run:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
