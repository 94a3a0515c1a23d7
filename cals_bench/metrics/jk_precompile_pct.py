"""The jackknife driver's ``precompile_buckets`` on every call: the seconds
of the program's ``jk.precompile`` spans over the jobs' summed walls, in
percent. None where the program recorded no such span."""

from cals_bench import program_spans


def read(run):
    rec = program_spans.recorded()
    if rec is None or not any(s.name == "jk.precompile" for s in rec[0]):
        return None
    return 100.0 * program_spans.seconds(rec[0], "jk.precompile") / sum(j.wall_s for j in run.jobs)
