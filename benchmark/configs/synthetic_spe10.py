"""The synthetic SPE10 permeability, made from its own seed.

Frozen copy of `synthetic_spe10_perm` of parelagmc_tpu_torch/physics/spe10.py
at commit 0ca6bbb: layered in z with smooth in-plane log-normal variation
(six low-order Fourier modes a layer) and ~1e6 contrast, the vertical
permeability a tenth of the horizontal. The real field (`spe_perm.dat`,
SPE comparative solution project model 2) is not in the repository.
"""

from typing import Sequence

import numpy as np


def permeability(ncells: Sequence[int], seed: int) -> np.ndarray:
    """(n_cells, 3) permeability Kx, Ky, Kz, x fastest."""
    nx, ny, nz = ncells
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    logk = np.zeros((nz, ny, nx))
    for z in range(nz):
        layer_mean = 3.0 * np.sin(2.5 * z / max(nz - 1, 1) * np.pi) - 1.0
        field = np.full((ny, nx), layer_mean)
        for _ in range(6):
            ax, ay = rng.integers(1, 6, size=2)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.5, 2.0)
            field = field + amp * np.outer(
                np.sin(2 * np.pi * ay * y + ph1), np.sin(2 * np.pi * ax * x + ph2))
        logk[z] = field
    kh = np.exp(logk).ravel()
    return np.stack([kh, kh, 0.1 * kh], axis=1)
