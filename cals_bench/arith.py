"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: the card's peaks, the operations of an ALS iteration and of its
MTTKRPs (copies of ``cp_cals_tpu_torch/ops/mttkrp.py:mttkrp_flops`` and
``als_iteration_flops``), the bytes an MTTKRP needs at least, and the
useful work of a job.

Useful work counts each model at its own rank (no padded columns), its
reported iterations and the polish sweeps it is known to take (the
traffic's ``polish_iters`` where every model takes them all; none where
``polish_tol`` stops each model on its own, since no report says how many
it took). The mixed-tier check's extra MTTKRP is not counted.
"""

from __future__ import annotations

import math

# NVIDIA's data-sheet dense peaks for the H100 SXM (bf16 on the tensor
# cores without sparsity, fp32 on the CUDA cores, HBM3), keyed by
# torch.cuda.get_device_name. Published figures at the full 700 W power
# limit, not measurements: every share is stated beside the card's limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, fp32_tflops=67.0, hbm_tb_s=3.35),
}

# The peak each precision tier's products are held to (each algorithmic
# operation counted once: "high" runs three bf16 passes and is still held
# to the bf16 peak), and the bytes an element of the tier's held tensor
# takes (bf16; a bf16 hi/lo pair; float32).
TIER_PEAK = {"default": "bf16_tflops", "high": "bf16_tflops", "highest": "fp32_tflops"}
X_BYTES = {"default": 2, "high": 4, "highest": 4}
FACTOR_BYTES = 4


def mttkrp_flops(modes, rank: int, mode: int, batch: int = 1) -> int:
    """Operations of the KRP-GEMM formulation of one batched MTTKRP."""
    p = math.prod(m for i, m in enumerate(modes) if i != mode)
    return p * rank * batch + 2 * modes[mode] * p * rank * batch


def als_iteration_flops(modes, rank: int, batch: int = 1) -> int:
    """Operations of one full ALS iteration (every mode's MTTKRP and update)."""
    total = 0
    for n in range(len(modes)):
        total += mttkrp_flops(modes, rank, n, batch)
        total += batch * (3 * modes[n] * rank * rank + rank**3 // 3)
    return total


def job_work(modes, models, main_tier: str, polish_tier: str, polish_sweeps: int) -> dict:
    """Useful work of one job. ``models``: (rank, reported iterations) per
    model; every model also takes ``polish_sweeps`` sweeps at
    ``polish_tier``.

    ``mttkrp_flops``: by tier. ``mttkrp_bytes``: the least any
    implementation reads and writes: the tensor once per sweep and mode
    for all models together (at its tier's width), and each model's other
    factors read and result written once per sweep and mode."""
    als = 0
    flops = {main_tier: 0, polish_tier: 0}
    factor_bytes = 0
    most = 0
    for rank, iters in models:
        als += als_iteration_flops(modes, rank) * (iters + polish_sweeps)
        per_sweep = sum(mttkrp_flops(modes, rank, n) for n in range(len(modes)))
        flops[main_tier] += per_sweep * iters
        flops[polish_tier] += per_sweep * polish_sweeps
        factor_bytes += FACTOR_BYTES * rank * len(modes) * sum(modes) * (iters + polish_sweeps)
        most = max(most, iters)
    x = math.prod(modes) * len(modes)
    x_bytes = x * (X_BYTES[main_tier] * most + X_BYTES[polish_tier] * (polish_sweeps if models else 0))
    return dict(als_flops=als, mttkrp_flops=flops, mttkrp_bytes=x_bytes + factor_bytes)


def bound_seconds(flops_by_tier: dict, nbytes: float, peaks: dict) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over their tiers' peaks and the bytes over the HBM bandwidth, and which
    of the two bounds it."""
    ops = sum(f / (peaks[TIER_PEAK[t]] * 1e12) for t, f in flops_by_tier.items())
    mem = nbytes / (peaks["hbm_tb_s"] * 1e12)
    return (ops, "operations") if ops >= mem else (mem, "bytes")
