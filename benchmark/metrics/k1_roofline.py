"""K1's share of its roofline, in %: the least time of the M(w)^{-1} line
solves it ran in the profiled batches (the bytes they need, each read or
written once, over the HBM peak of benchmark/peaks.json) over K1's summed
device time (profiler, kernels by name). See tracedata.k1_roofline."""

import tracedata


def read(run):
    return tracedata.k1_roofline(run)
