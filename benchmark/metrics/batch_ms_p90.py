"""The 90th percentile (linear interpolation) of one batch's wall over all
batches of the window, in ms; each batch ends with the manager's copy of
its Q values to the host, so its wall is synchronized."""

import numpy as np


def read(run):
    return float(np.percentile([1e3 * (t1 - t0) for t0, t1, _ in run.units], 90))
