"""Blocking device-to-host reads per batch: the program's `host_syncs.*`
counters' change over each profiled `mlmc.batch` span, mean over the
batches (programspans.py)."""

import programspans


def read(run):
    return programspans.host_syncs_per_batch(run)
