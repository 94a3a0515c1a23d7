"""The host's wait on the card in the bucket loop: the seconds of the
program's ``loop.fetch`` spans (the host blocked in a chunk's stats fetch,
a polish check or an eviction round's fetch, from the copy's event to the
copy out), over the jobs' summed walls, in percent. The rest of the wall
is the host's own work. None where the program recorded no spans (a
``--trace 0`` run, or a program without its recorder)."""

from cals_bench import program_spans


def read(run):
    rec = program_spans.recorded()
    if rec is None:
        return None
    return 100.0 * program_spans.seconds(rec[0], "loop.fetch") / sum(j.wall_s for j in run.jobs)
