"""The MTTKRP kernels' share of their roofline, in percent: the least time
the card needs for the window's useful MTTKRP work (operations at each
tier's peak, or the least bytes at the HBM bandwidth, whichever is longer;
``arith.job_work``, ``arith.bound_seconds``) over the device time of the
kernels that ``kernels/mttkrp.json`` assigns to the MTTKRP. The work is
counted at the models' own ranks whatever implements it, so an honest
kernel cannot pass 100 %. None without a trace, a known card, or MTTKRP
kernel time."""

from cals_bench import arith


def read(run):
    if run.trace is None or run.peaks is None or not run.trace.family_s.get("mttkrp"):
        return None
    flops, nbytes = {}, 0
    for j in run.jobs:
        for tier, f in j.work["mttkrp_flops"].items():
            flops[tier] = flops.get(tier, 0) + f
        nbytes += j.work["mttkrp_bytes"]
    bound, _ = arith.bound_seconds(flops, nbytes, run.peaks)
    return 100.0 * bound / run.trace.family_s["mttkrp"]
