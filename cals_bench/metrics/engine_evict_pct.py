"""The engine's eviction share: the host seconds of its eviction rounds
(``CalsReport.phase_times[bucket]["evict"]``: stats, the results' fetch,
refill, kill, compaction), summed over buckets and jobs, over the jobs'
summed walls, in percent."""


def read(run):
    return 100.0 * sum(j.evict_s for j in run.jobs) / sum(j.wall_s for j in run.jobs)
