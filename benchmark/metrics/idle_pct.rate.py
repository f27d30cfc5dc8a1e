"""Device idle share of the profiled batches, in %: 100 (1 - union of the
device operations' intervals / the profiled window)."""

import tracedata


def read(run):
    return tracedata.idle_pct(run)
