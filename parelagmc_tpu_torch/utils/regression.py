"""Weighted log-log rate regression used by the MC/MLMC managers.

Mirrors the reference's expWRegression
(ParELAGMC src/Utilities.cpp:257-283) exactly: a no-intercept
weighted fit of the pairwise log-ratios log|y_i/y_{i+1}| against
log(x_i/x_{i+1}) with geometric weights 0.5^i (finer-level pairs count
more), using the first n = len(y) - 1 - skip_n_last pairs.

One deliberate deviation from the reference: the
reference returns the raw slope, which is NEGATIVE for convergent MLMC
(|y| shrinks as the dof count x grows); this function returns the NEGATED
slope, i.e. the positive decay rate `a` in y ~ C * x^(-a). Alpha/beta use
this positive-DECAY convention directly; for gamma the managers negate the
return again, back to the reference's raw-slope GROWTH convention
(cost ~ M^gamma, positive for physical cost models;
MLMC_Manager.cpp:384 - see uq/managers.py compute_nsamples_mse).

The port's own copy of parelagmc_tpu/utils/regression.py (host-side numpy, as
there): the port imports nothing of the JAX package. It keeps only
what the port calls.
"""

from __future__ import annotations

import numpy as np


def exp_weighted_regression(
    y: np.ndarray, x: np.ndarray, skip_n_last: int = 0
) -> float:
    y = np.asarray(y, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = y.shape[0] - 1 - skip_n_last
    if n < 1:
        return 0.0
    logdy = np.log(np.abs(y[:n] / np.where(y[1 : n + 1] == 0, 1e-300, y[1 : n + 1])) + 1e-300)
    logdx = np.log(x[:n] / x[1 : n + 1])
    w = 0.5 ** np.arange(n)
    denom = float((w * logdx * logdx).sum())
    if denom <= 0.0:
        return 0.0
    slope = float((w * logdy * logdx).sum()) / denom
    return -slope
