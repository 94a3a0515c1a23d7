"""Set-up: from the process's start to the first timed job: imports, the
card's start, the kernels' build or load, the inputs made from the seed,
the jackknife's base model, and one untimed warm-up job."""


def read(run):
    return run.setup_s
