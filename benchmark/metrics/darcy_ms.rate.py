"""Darcy time per batch, in ms: the synchronized spans around the batch's
solves (`solve_fwd_pair`, or a level's own `solve_fwd`) over the window's
batches."""

import tracedata


def read(run):
    return tracedata.per_batch_span_ms(run, ("darcy", "solve."))
