"""The jackknife drivers' host share: each job's wall outside the engine
call (``JKReport.solver_time``), summed over the window's jobs, over the
jobs' summed walls, in percent. It covers replicate generation, the
warm-up lookups, norms, rescaling and LSAP. None for a job kind without a
solver span."""


def read(run):
    if not run.jobs or run.jobs[0].solver_s is None:
        return None
    wall = sum(j.wall_s for j in run.jobs)
    return 100.0 * sum(j.wall_s - j.solver_s for j in run.jobs) / wall
