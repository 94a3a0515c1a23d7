"""The whole job's share of the card's peak, in percent: the useful ALS
operations of the window's jobs (``arith.als_iteration_flops`` at each
model's own rank, its reported iterations and the polish sweeps it is
known to take) over the window's seconds times the peak of the cell's
MTTKRP tier (bf16 989 TFLOP/s at "default" and "high", fp32 67 at
"highest"). It bounds the MTTKRP's roofline share from the whole step:
a kernel taken off the path leaves its own share silent, not this."""

from cals_bench import arith


def read(run):
    if run.peaks is None:
        return None
    flops = sum(j.work["als_flops"] for j in run.jobs)
    peak = run.peaks[arith.TIER_PEAK[run.tiers[0]]] * 1e12
    return 100.0 * flops / (run.window_s * peak)
