"""The reference problem of a configuration file: levels, fields, Darcy
levels; and the Q of given samples.

The grid is the configuration's: a box of `ncells` coarsest cells refined
`refinements` times, or the SPE10 grid of 60 x 220 x 85 cells of
20 x 10 x 2 ft. With `axis_order` "auto" the axis with the most cells is
the first (x) axis, the others keep their order: the noise of a sample is
laid out on that grid, so the reference builds the same relabelled box,
and relabels the permeability and the boundary sides with it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import threefry
from .galerkin import galerkin_chain
from .mixed import (BDR_ATTR, DarcyLevel, Level, Precision, SPDEField, level_axes,
                    level_noise_rhs)

SPE10_CELLS = (60, 220, 85)
SPE10_FEET = (20.0, 10.0, 2.0)


def fine_grid(p: dict):
    """(cells per axis, cell widths per axis) of the finest level."""
    if p.get("mesh", "box") == "spe10":
        return list(SPE10_CELLS), list(SPE10_FEET)
    f = 2 ** int(p.get("refinements", 2))
    n = [int(c) * f for c in p.get("ncells", (4, 4, 4))]
    return n, [float(L) / c for L, c in zip(p.get("lengths", (2.0, 2.0, 2.0)), n)]


def axis_order(p: dict, n: Sequence[int]) -> List[int]:
    if p.get("axis_order") == "auto":
        i = int(np.argmax(n))
        return [i] + [a for a in range(len(n)) if a != i]
    return list(range(len(n)))


def relabel_sides(attrs: Sequence[int], order: Sequence[int]) -> List[int]:
    """The side flags of the relabelled box: new (axis i, side s) is the
    original (axis order[i], side s)."""
    new = list(attrs)
    for i in range(len(order)):
        for s in (0, 1):
            new[BDR_ATTR[(i, s)] - 1] = attrs[BDR_ATTR[(order[i], s)] - 1]
    return new


def relabel_cells(field: np.ndarray, n: Sequence[int], order: Sequence[int]) -> np.ndarray:
    """An x-fastest (n_s, d) per-cell field of the original grid on the
    relabelled grid (and its columns relabelled)."""
    d = len(n)
    g = field.reshape(tuple(n[::-1]) + (d,))  # (z, y, x, d)
    # Array dim j of the new grid holds new axis d-1-j = original order[d-1-j],
    # which is original array dim d-1-order[d-1-j].
    perm = [d - 1 - order[d - 1 - j] for j in range(d)] + [d]
    g = np.transpose(g, perm)[..., list(order)]
    return np.ascontiguousarray(g).reshape(-1, d)


class ReferenceProblem:
    def __init__(self, spec: dict, kinv: Optional[np.ndarray] = None):
        p = spec["problem"]
        self.dtype = p.get("dtype", "float32")
        n, h = fine_grid(p)
        order = axis_order(p, n)
        if kinv is not None:
            kinv = np.asarray(kinv, dtype=np.float64)
            if kinv.ndim == 1:
                kinv = np.repeat(kinv[:, None], len(n), axis=1)
            kinv = relabel_cells(kinv, n, order)
        n = [n[a] for a in order]
        h = [h[a] for a in order]
        self.order = order
        ess = relabel_sides(p.get("ess_attr", (0, 1, 1, 1, 1, 0)), order)
        obs = relabel_sides(p.get("obs_attr", (1, 0, 0, 0, 0, 0)), order)
        inflow = relabel_sides(p.get("inflow_attr", (0, 0, 0, 0, 0, 1)), order)
        nlevels = int(p.get("nlevels") or int(p.get("refinements", 2)) + 1)
        axes = level_axes([hh * np.arange(c + 1) for c, hh in zip(n, h)], nlevels)
        self.levels = [Level(a) for a in axes]
        self.corlen = float(p.get("correlation_length", 0.1))
        self.variance = float(p.get("variance", 1.0))
        self.normalize = bool(p.get("normalize_marginals", False))
        self._fields = {}
        if kinv is None:
            blocks = [lvl.plain_blocks() for lvl in self.levels]
            restrict = None
        else:
            blocks, restrict = galerkin_chain(self.levels, kinv)
        self.darcy = []
        rhs_u = obs_u = None
        for l, lvl in enumerate(self.levels):
            if l > 0 and restrict is not None:
                rhs_u = restrict[l - 1].T @ rhs_u
                obs_u = restrict[l - 1].T @ obs_u
            dl = (DarcyLevel(lvl, blocks[l], ess, obs, inflow, rhs_u=rhs_u, obs_u=obs_u)
                  if l > 0 and restrict is not None
                  else DarcyLevel(lvl, blocks[l], ess, obs, inflow))
            if l == 0:
                rhs_u = np.zeros(lvl.n_u)
                rhs_u[dl.active] = dl.f
                obs_u = np.zeros(lvl.n_u)
                obs_u[dl.active] = dl.c
            self.darcy.append(dl)

    def field(self, level: int) -> SPDEField:
        if level not in self._fields:
            self._fields[level] = SPDEField(self.levels[level], self.corlen, self.variance,
                                            self.normalize)
        return self._fields[level]

    def coefficients(self, key, batch: int, rows: Sequence[int], xi_level: int,
                     level: int, prec: Precision) -> np.ndarray:
        """w = exp(s) on `level` of the given rows of a batch drawn with
        `key` on `xi_level`: (len(rows), n_s)."""
        n_s = self.levels[xi_level].n_s
        xi = threefry.normals_rows(key, n_s, rows, self.dtype, prec.device)
        fld = self.field(level)
        rhs = level_noise_rhs(self.levels, xi.cpu().numpy(), xi_level, level,
                              fld.g * fld.sigma, prec)
        return torch.exp(fld.field(rhs, prec).to(torch.float64)).cpu().numpy()

    def q(self, level: int, w: np.ndarray, solver) -> np.ndarray:
        """Q of each row of w on `level`; solver(darcy_level, w) -> Q of
        each row."""
        return np.asarray(solver(self.darcy[level], w), dtype=np.float64)
