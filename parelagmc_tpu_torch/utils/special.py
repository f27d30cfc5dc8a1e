"""Special functions for Matern covariance machinery.

* matern_spde_scaling: the white-noise scaling coefficient g of the SPDE
  sampler. The reference implementation
  (ParELAGMC src/Utilities.hpp:187-200) computes

      g = sqrt( (4*pi)^(d/2) * Gamma(nu + d) * kappa^(2*nu) / Gamma(nu) ),

  with nu = 2 - d/2 and kappa = 1/correlation_length. (Its doc comment says
  Gamma(nu + d/2), but the code uses Gamma(nu + d); we reproduce the code,
  since the golden values derive from it.)

The port's own copy of matern_spde_scaling from parelagmc_tpu/utils/special.py
(host code; the Bessel functions of the KL samplers stay out).
"""

from __future__ import annotations

import math


def matern_spde_scaling(correlation_length: float, ndim: int) -> float:
    d = float(ndim)
    nu = 2.0 - d / 2.0
    c = (4.0 * math.pi) ** (d / 2.0)
    k = (1.0 / correlation_length) ** (2.0 * nu)
    return math.sqrt(c * math.gamma(nu + d) * k / math.gamma(nu))
