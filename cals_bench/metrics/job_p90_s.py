"""The 90th percentile of the window's job walls, numpy's linear
interpolation between order statistics (with 100 jobs or more, at least
ten lie beyond it)."""

import numpy as np


def read(run):
    return float(np.percentile([j.wall_s for j in run.jobs], 90))
