"""Sampler time per batch, in ms: the synchronized spans around
`sample` and `eval` (or `eval_pair`) over the window's batches."""

import tracedata


def read(run):
    return tracedata.per_batch_span_ms(run, ("sampler",))
