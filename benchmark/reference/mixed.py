"""Plain reference of the tensor-grid MLMC sample: noise, SPDE field, Darcy
solve, quantity of interest.

Written from the mathematics of the configuration alone; it imports nothing
of the program it judges.

* Grid: an axis-aligned box of cells, x fastest; level l+1 keeps every
  second grid line of level l (the last line always, so an odd count merges
  its trailing cell into the last coarse cell).
* Mixed RT0/P0 on each level: face fluxes u, cell values p. B[c, f] = +1
  when f is the high face of c along its axis, -1 when the low one. The
  velocity mass is a sum of per-(cell, axis) 2x2 blocks on the cell's (lo,
  hi) faces; on a plain level the block is h_a^2/V * [[1/3, 1/6], [1/6,
  1/3]] (times the inverse permeability, when there is one).
* SPDE field (Matern, nu = 2 - d/2): s = S^{-1} (g W^{1/2} sigma xi) with
  S = B M^{-1} B^T + W / corlen^2 and every boundary flux zero, by the fast
  diagonalisation of the per-axis Schur operators; the noise of a finer
  level is summed into the coarse cells first. Optionally scaled to unit
  marginal variance per cell (times sigma), then w = exp(s).
* Darcy: [[M(w), B^T], [B, 0]] [u; p] = [f; 0] with the essential boundary
  faces removed, f = +/-1 on the inflow faces (pressure 1 there), and the
  effective-permeability QoI Q = outward flux through the observation
  faces.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

# (axis, side) -> MFEM boundary attribute of a generated 3D box mesh.
BDR_ATTR = {(2, 0): 1, (1, 0): 2, (0, 1): 3, (1, 1): 4, (0, 0): 5, (2, 1): 6}


def coarsen_lines(lines: np.ndarray) -> np.ndarray:
    if lines.size <= 2:
        return lines
    out = lines[::2].copy()
    out[-1] = lines[-1]
    return out


def level_axes(fine_axes: Sequence[np.ndarray], nlevels: int) -> List[List[np.ndarray]]:
    """Grid lines of every level, finest first."""
    out = [[np.asarray(a, dtype=np.float64) for a in fine_axes]]
    for _ in range(nlevels - 1):
        out.append([coarsen_lines(a) for a in out[-1]])
    return out


def parent_1d(fine: np.ndarray, coarse: np.ndarray) -> np.ndarray:
    mid = 0.5 * (fine[1:] + fine[:-1])
    return np.searchsorted(coarse, mid) - 1


class Level:
    """Faces, cells and the sparse operators of one tensor-grid level."""

    def __init__(self, axes: Sequence[np.ndarray]):
        self.axes = [np.asarray(a, dtype=np.float64) for a in axes]
        self.d = len(self.axes)
        self.shape = tuple(a.size - 1 for a in self.axes)  # cells per axis (x, y, z)
        self.h = [np.diff(a) for a in self.axes]
        self.n_s = int(np.prod(self.shape))
        rshape = self.shape[::-1]
        vol = np.ones(rshape)
        for a in range(self.d):
            vol = vol * self.h[a].reshape([-1 if i == self.d - 1 - a else 1
                                           for i in range(self.d)])
        self.vol = vol.reshape(-1)
        # Faces per axis, numbered after the previous axes' faces.
        self.face_shape = []
        self.face_off = [0]
        for a in range(self.d):
            fs = list(rshape)
            fs[self.d - 1 - a] += 1
            self.face_shape.append(tuple(fs))
            self.face_off.append(self.face_off[-1] + int(np.prod(fs)))
        self.n_u = self.face_off[-1]
        cells = np.arange(self.n_s).reshape(rshape)
        self.cell_lo = []  # per axis: (n_s,) index of each cell's low face
        self.cell_hi = []
        for a in range(self.d):
            dim = self.d - 1 - a
            fid = self.face_off[a] + np.arange(int(np.prod(self.face_shape[a]))).reshape(
                self.face_shape[a])
            n = self.shape[a]
            lo = np.take(fid, np.arange(n), axis=dim)
            hi = np.take(fid, np.arange(1, n + 1), axis=dim)
            self.cell_lo.append(lo.reshape(-1))
            self.cell_hi.append(hi.reshape(-1))
        del cells
        # Boundary side of each face: attribute, outward sign.
        self.bdr = np.zeros(self.n_u, dtype=np.int64)
        self.outward = np.zeros(self.n_u)
        for a in range(self.d):
            dim = self.d - 1 - a
            fid = self.face_off[a] + np.arange(int(np.prod(self.face_shape[a]))).reshape(
                self.face_shape[a])
            lo = np.take(fid, 0, axis=dim).reshape(-1)
            hi = np.take(fid, self.shape[a], axis=dim).reshape(-1)
            self.bdr[lo] = BDR_ATTR[(a, 0)]
            self.bdr[hi] = BDR_ATTR[(a, 1)]
            self.outward[lo] = -1.0
            self.outward[hi] = 1.0

    def cell_widths(self, a: int) -> np.ndarray:
        g = np.broadcast_to(self.h[a].reshape([-1 if i == self.d - 1 - a else 1
                                               for i in range(self.d)]), self.shape[::-1])
        return g.reshape(-1)

    def plain_blocks(self, kinv: Optional[np.ndarray] = None):
        """(bll, blr, brr), each (n_s, d): the RT0 mass blocks of this level
        rediscretised, times kinv[:, a] when given."""
        bll = np.zeros((self.n_s, self.d))
        for a in range(self.d):
            h = self.cell_widths(a)
            bll[:, a] = h * h / (3.0 * self.vol)
        if kinv is not None:
            bll = bll * kinv
        return bll, 0.5 * bll, bll.copy()

    def side_mask(self, attrs: Sequence[int]) -> np.ndarray:
        """Faces on the boundary sides whose attribute is flagged in
        `attrs` (MFEM convention: attrs[attr - 1] == 1)."""
        flags = np.asarray(attrs, dtype=np.int64)
        on = self.bdr > 0
        out = np.zeros(self.n_u, dtype=bool)
        out[on] = flags[self.bdr[on] - 1] == 1
        return out

    def b_matrix(self) -> sp.csr_matrix:
        rows = np.concatenate([np.arange(self.n_s)] * (2 * self.d))
        cols = np.concatenate([x for a in range(self.d) for x in (self.cell_lo[a],
                                                                  self.cell_hi[a])])
        vals = np.concatenate([v for a in range(self.d)
                               for v in (-np.ones(self.n_s), np.ones(self.n_s))])
        return sp.csr_matrix((vals, (rows, cols)), shape=(self.n_s, self.n_u))

    def mass_matrix(self, blocks, w: np.ndarray) -> sp.csr_matrix:
        """M(w) = sum over cells and axes of w_c * block on (lo, hi)."""
        bll, blr, brr = blocks
        rows, cols, vals = [], [], []
        for a in range(self.d):
            lo, hi = self.cell_lo[a], self.cell_hi[a]
            for r, c, v in ((lo, lo, bll[:, a]), (lo, hi, blr[:, a]),
                            (hi, lo, blr[:, a]), (hi, hi, brr[:, a])):
                rows.append(r)
                cols.append(c)
                vals.append(w * v)
        return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                     np.concatenate(cols))),
                             shape=(self.n_u, self.n_u))


def restrict_sum(x: np.ndarray, fine: Level, coarse: Level) -> np.ndarray:
    """Sum a (batch, n_s fine) cell field into the coarse cells."""
    out = x.reshape((x.shape[0],) + fine.shape[::-1])
    for a in range(fine.d):
        dim = 1 + fine.d - 1 - a
        par = parent_1d(fine.axes[a], coarse.axes[a])
        R = np.zeros((coarse.shape[a], fine.shape[a]))
        R[par, np.arange(fine.shape[a])] = 1.0
        out = np.moveaxis(np.tensordot(out, R, axes=([dim], [1])), -1, dim)
    return out.reshape(x.shape[0], -1)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), nearest
    even, as the tensor cores take their inputs."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


class Precision:
    """How the reference computes, and on which device: 'float64' (the
    reference) or 'tf32' (float32 storage, matmul inputs rounded to TF32:
    the control)."""

    def __init__(self, name: str = "float64", device="cpu"):
        if name not in ("float64", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.device = torch.device(device)
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def cast(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _round_tf32(a) @ _round_tf32(b)
        return a @ b


class SPDEField:
    """The Matern SPDE field of one level by fast diagonalisation."""

    def __init__(self, lvl: Level, corlen: float, variance: float, normalize: bool):
        self.lvl = lvl
        d = lvl.d
        nu = 2.0 - d / 2.0
        kappa = 1.0 / corlen
        # White-noise scaling of the Matern SPDE (the reference C++ code's
        # Gamma(nu + d), src/Utilities.hpp).
        self.g = math.sqrt((4 * math.pi) ** (d / 2) * math.gamma(nu + d)
                           * kappa ** (2 * nu) / math.gamma(nu))
        self.sigma = math.sqrt(variance)
        alpha = kappa ** 2
        self.V, lams = [], []
        for a in range(d):
            h = lvl.h[a]
            n = h.size
            # Interior faces 1..n-1 along the axis (boundary fluxes zero).
            T = np.zeros((n - 1, n - 1))
            D = np.zeros((n, n - 1))
            for f in range(n - 1):
                T[f, f] = (h[f] + h[f + 1]) / 3.0
                if f + 1 < n - 1:
                    T[f, f + 1] = T[f + 1, f] = h[f + 1] / 6.0
                D[f, f] = 1.0  # face f+1 is the high face of cell f
                D[f + 1, f] = -1.0
            A = D @ np.linalg.solve(T, D.T) if n > 1 else np.zeros((1, 1))
            hs = 1.0 / np.sqrt(h)
            lam, U = np.linalg.eigh(0.5 * (hs[:, None] * A * hs[None, :]
                                           + (hs[:, None] * A * hs[None, :]).T))
            self.V.append(hs[:, None] * U)
            lams.append(np.maximum(lam, 0.0))
        rshape = lvl.shape[::-1]
        den = np.full(rshape, alpha)
        for a in range(d):
            den = den + lams[a].reshape([-1 if i == d - 1 - a else 1 for i in range(d)])
        self.inv_den = 1.0 / den
        self.scale = None
        if normalize:
            prec = Precision()
            z = prec.cast(self.inv_den ** 2)
            for a in range(d):
                z = self._axis(z, prec.cast((self.V[a] ** 2).T), a, batch=False, prec=prec)
            # Cov = g^2 S^-1 W S^-1 = g^2 V diag(inv_den^2) V^T.
            self.scale = 1.0 / (self.g * np.sqrt(z.numpy().reshape(-1)))

    def _axis(self, x, mat, a, batch: bool, prec: "Precision"):
        """x @ mat along the array dim of mesh axis a."""
        dim = (1 if batch else 0) + self.lvl.d - 1 - a
        y = torch.movedim(x, dim, -1)
        y = prec.matmul(y, mat)
        return torch.movedim(y, -1, dim)

    def field(self, rhs: torch.Tensor, prec: Precision) -> torch.Tensor:
        """log field s = S^{-1} rhs (rhs = g sigma W^{1/2} xi, summed to this
        level), scaled per cell when normalised; (batch, n_s)."""
        lvl = self.lvl
        z = prec.cast(rhs).reshape((rhs.shape[0],) + lvl.shape[::-1])
        for a in range(lvl.d):  # V^T along every axis
            z = self._axis(z, prec.cast(self.V[a]), a, True, prec)
        z = z * prec.cast(self.inv_den)
        for a in range(lvl.d):  # V along every axis
            z = self._axis(z, prec.cast(self.V[a].T), a, True, prec)
        s = z.reshape(rhs.shape[0], -1)
        if self.scale is not None:
            s = s * prec.cast(self.scale)
        return s


class DarcyLevel:
    """The Darcy saddle system of one level, essential faces removed."""

    def __init__(self, lvl: Level, blocks, ess_attr, obs_attr, inflow_attr,
                 rhs_u: Optional[np.ndarray] = None, obs_u: Optional[np.ndarray] = None):
        self.lvl = lvl
        self.blocks = blocks
        ess = lvl.side_mask(ess_attr)
        self.active = np.nonzero(~ess)[0]
        if rhs_u is None:
            inflow = lvl.side_mask(inflow_attr)
            rhs_u = np.where(inflow, -lvl.outward, 0.0)
        if obs_u is None:
            obs = lvl.side_mask(obs_attr)
            obs_u = np.where(obs, lvl.outward, 0.0)
        self.f = rhs_u[self.active]
        self.c = obs_u[self.active]
        self.B = lvl.b_matrix()[:, self.active].tocsr()

    def solve(self, w: np.ndarray):
        """(Q, p) for one coefficient field w (n_s,) by a sparse LU solve;
        p is the cell unknown of the system above (minus the physical
        pressure)."""
        M = self.lvl.mass_matrix(self.blocks, w)[self.active][:, self.active]
        K = sp.bmat([[M, self.B.T], [self.B, None]], format="csc")
        x = spla.splu(K).solve(np.concatenate([self.f, np.zeros(self.lvl.n_s)]))
        return float(np.dot(self.c, x[: self.active.size])), x[self.active.size:]


def level_noise_rhs(levels: Sequence[Level], xi: np.ndarray, xi_level: int, level: int,
                    g_sigma: float, prec: Precision) -> torch.Tensor:
    """g sigma W^{1/2} xi on the noise's level, summed into `level`."""
    rhs = g_sigma * np.sqrt(levels[xi_level].vol)[None, :] * np.asarray(xi, np.float64)
    for l in range(xi_level, level):
        rhs = restrict_sum(rhs, levels[l], levels[l + 1])
    return prec.cast(rhs)
