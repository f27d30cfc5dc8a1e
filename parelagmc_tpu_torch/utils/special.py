"""Special functions for Matern covariance machinery.

* bessi1 / bessk1: modified Bessel functions of order 1 (polynomial
  approximations following Numerical Recipes ch. 6.6), used by the dense
  Matern covariance kernel in 2D (nu = 1; in 3D nu = 1/2 gives the exp
  kernel).
* matern_spde_scaling: the white-noise scaling coefficient g of the SPDE
  sampler. The reference implementation
  (ParELAGMC src/Utilities.hpp:187-200) computes

      g = sqrt( (4*pi)^(d/2) * Gamma(nu + d) * kappa^(2*nu) / Gamma(nu) ),

  with nu = 2 - d/2 and kappa = 1/correlation_length. (Its doc comment says
  Gamma(nu + d/2), but the code uses Gamma(nu + d); we reproduce the code,
  since the golden values derive from it.)

The port's own copy of parelagmc_tpu/utils/special.py (NumPy host code).
"""

from __future__ import annotations

import math

import numpy as np


def matern_spde_scaling(correlation_length: float, ndim: int) -> float:
    d = float(ndim)
    nu = 2.0 - d / 2.0
    c = (4.0 * math.pi) ** (d / 2.0)
    k = (1.0 / correlation_length) ** (2.0 * nu)
    return math.sqrt(c * math.gamma(nu + d) * k / math.gamma(nu))


def bessi1(x):
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    # Small-argument branch.
    y_s = (x / 3.75) ** 2
    small = ax * (
        0.5
        + y_s
        * (
            0.87890594
            + y_s
            * (
                0.51498869
                + y_s
                * (
                    0.15084934
                    + y_s * (0.2658733e-1 + y_s * (0.301532e-2 + y_s * 0.32411e-3))
                )
            )
        )
    )
    # Large-argument branch.
    with np.errstate(divide="ignore", invalid="ignore"):
        y_l = 3.75 / np.where(ax > 0, ax, 1.0)
        inner = 0.2282967e-1 + y_l * (
            -0.2895312e-1 + y_l * (0.1787654e-1 - y_l * 0.420059e-2)
        )
        large = 0.39894228 + y_l * (
            -0.3988024e-1
            + y_l * (-0.362018e-2 + y_l * (0.163801e-2 + y_l * (-0.1031555e-1 + y_l * inner)))
        )
        large = large * np.exp(ax) / np.sqrt(np.where(ax > 0, ax, 1.0))
    ans = np.where(ax < 3.75, small, large)
    return np.where(x < 0.0, -ans, ans)


def bessk1(x):
    x = np.asarray(x, dtype=np.float64)
    xs = np.where(x > 0, x, 1.0)
    # Small-argument branch (x <= 2).
    y_s = xs * xs / 4.0
    small = (np.log(xs / 2.0) * bessi1(xs)) + (1.0 / xs) * (
        1.0
        + y_s
        * (
            0.15443144
            + y_s
            * (
                -0.67278579
                + y_s
                * (
                    -0.18156897
                    + y_s * (-0.1919402e-1 + y_s * (-0.110404e-2 + y_s * (-0.4686e-4)))
                )
            )
        )
    )
    # Large-argument branch (x > 2).
    y_l = 2.0 / xs
    large = (np.exp(-xs) / np.sqrt(xs)) * (
        1.25331414
        + y_l
        * (
            0.23498619
            + y_l
            * (
                -0.3655620e-1
                + y_l
                * (
                    0.1504268e-1
                    + y_l * (-0.780353e-2 + y_l * (0.325614e-2 + y_l * (-0.68245e-3)))
                )
            )
        )
    )
    return np.where(x <= 2.0, small, large)
