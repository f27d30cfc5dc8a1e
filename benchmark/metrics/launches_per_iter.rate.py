"""Device operations in the profiled batches over the Krylov iterations
of its solves (profiler trace and the solves' info.iterations)."""

import tracedata


def read(run):
    return tracedata.launches_per_iter(run)
