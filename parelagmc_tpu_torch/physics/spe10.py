"""SPE10 permeability data and the full-grid production solver settings.

Port of parelagmc_tpu/physics/spe10.py (numpy; the reference module sits
in a package whose import pulls in jax). The SPE comparative-solution
project model 2 (`spe_perm.dat`: a 60x220x85 grid of 20x10x2 ft cells, three
Kx/Ky/Kz blocks of 1,122,000 values, x fastest) feeds the INVERSE
permeability to the velocity mass as the static kinv_ref; the per-sample
random field multiplies on top. Without the file, `load_spe10_kinv` uses
the reference's deterministic synthetic layered log-normal field with
SPE10-like contrast (~1e6).

`full_grid_solver_defaults` is the production solver configuration of
examples/spe10_mlmc.py for the full grid.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, Optional, Sequence

import numpy as np

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING  # noqa: F401


def read_spe_perm(path: str, ncells: Sequence[int] = SPE10_NCELLS) -> np.ndarray:
    """Read spe_perm.dat: permeability (nx*ny*nz, 3) in cell order (x
    fastest), columns Kx, Ky, Kz."""
    n = int(np.prod(ncells))
    vals = np.loadtxt(path).ravel()
    if vals.size < 3 * n:
        raise ValueError(f"{path}: expected {3 * n} permeability values, got {vals.size}")
    return np.stack([vals[0:n], vals[n: 2 * n], vals[2 * n: 3 * n]], axis=1)


def synthetic_spe10_perm(ncells: Sequence[int] = SPE10_NCELLS, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic SPE10-like permeability (n_cells, 3): layered
    in z with smooth in-plane log-normal variation and ~1e6 contrast,
    vertical permeability 10x lower."""
    nx, ny, nz = ncells
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    logk = np.zeros((nz, ny, nx))
    for z in range(nz):
        layer_mean = 3.0 * np.sin(2.5 * z / max(nz - 1, 1) * np.pi) - 1.0
        field = np.full((ny, nx), layer_mean)
        for _ in range(6):  # low-order Fourier modes in (x, y)
            ax, ay = rng.integers(1, 6, size=2)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.5, 2.0)
            field = field + amp * np.outer(
                np.sin(2 * np.pi * ay * y + ph1), np.sin(2 * np.pi * ax * x + ph2)
            )
        logk[z] = field
    kh = np.exp(logk).ravel()  # (nz, ny, nx) raveled C-order = x fastest
    return np.stack([kh, kh, 0.1 * kh], axis=1)


def load_spe10_kinv(perm_file: Optional[str] = None, ncells: Sequence[int] = SPE10_NCELLS,
                    slice_2d: Optional[int] = None) -> np.ndarray:
    """Inverse permeability (n_cells, d) for the SPE10 Darcy problem; the
    synthetic field when `perm_file` is None or absent. slice_2d takes one
    XY layer and returns (nx*ny, 2)."""
    if perm_file is not None and os.path.exists(perm_file):
        k = read_spe_perm(perm_file, ncells)
    else:
        if perm_file is not None:
            print(f"# spe10: '{perm_file}' not found; using synthetic permeability",
                  file=sys.stderr)
        k = synthetic_spe10_perm(ncells)
    if slice_2d is not None:
        nx, ny, nz = ncells
        sl = k.reshape(nz, ny, nx, 3)[slice_2d]
        return 1.0 / sl.reshape(nx * ny, 3)[:, :2]
    return 1.0 / k


def full_grid_solver_defaults(cfg: ProblemConfig, overrides: Iterable[str] = ()) -> ProblemConfig:
    """The full-grid (60x220x85) production settings of
    examples/spe10_mlmc.py:27-113, in place; a darcy_solver field named in
    `overrides` keeps its value (the example's --solver-opt rule).

    The values are the reference's, kept as configuration: the split pair
    step with 4 segments of 75 iterations (the port runs each pair solve
    composed with that total budget), the adjoint-corrected QoI at rtol
    1e-4, cg-schur-coefmg with order-3 Chebyshev smoothing (lo 0.10) and a
    bfloat16 preconditioner state, mean-field initial iterates, and batches
    of 8 / 128 / 512 per level."""
    user = set(overrides)
    cfg.split_pair_programs = True
    cfg.solve_segments = 4
    ds = cfg.darcy_solver
    ds.name = "cg-schur-coefmg"
    if "adjoint_qoi" not in user:
        ds.adjoint_qoi = True
    if "relative_tolerance" not in user:
        ds.relative_tolerance = 1e-4 if ds.adjoint_qoi else 1e-6
    if "max_iterations" not in user:
        ds.max_iterations = 75 if ds.adjoint_qoi else 150
    if "coefmg_cheby_order" not in user:
        ds.coefmg_cheby_order = 3
    if "coefmg_cheby_lo" not in user:
        ds.coefmg_cheby_lo = 0.10
    if "coefmg_prec_dtype" not in user:
        ds.coefmg_prec_dtype = "bfloat16"
    if "meanfield_x0" not in user:
        ds.meanfield_x0 = True
    cfg.batch_size_per_level = [8, 128] + [512] * (cfg.nlevels - 2)
    return cfg
