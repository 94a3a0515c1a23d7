"""Models fitted per second: every model of every job that ran in the
window (a jackknife replicate is a model), over the window's seconds."""


def read(run):
    return sum(j.n_models for j in run.jobs) / run.window_s
