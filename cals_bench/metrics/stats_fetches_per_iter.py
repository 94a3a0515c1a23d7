"""The bucket loop's stats fetches (``CalsReport.loop_counts[bucket]
["stats_fetches"]``: one per chunk, per polish check and per eviction
round) per engine iteration (``engine_iterations``), over the window."""


def read(run):
    iters = sum(j.engine_iterations for j in run.jobs)
    return sum(j.stats_fetches for j in run.jobs) / iters if iters else None
