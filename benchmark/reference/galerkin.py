"""Energy-consistent coarse Darcy levels for a static inverse permeability.

The coarse velocity space of level l+1 is embedded in level l's by a
prolongator P whose axis-a coarse face basis spreads its flux over the fine
axis-a lines with weights alpha: on each line, the conductance of the
serial chain of cells of the two coarse cells next to the face,
c = 1 / sum(r_cell), r_cell = bll + 2 blr + brr (the energy of a unit
uniform flux through the cell), normalised over the lines inside one
coarse transverse cell. Along the axis a fine face inside a coarse cell
takes the linear blend (1 - t) alpha_lo + t alpha_hi of the cell's two
coarse faces. The coarse mass is the Galerkin product

    M_{l+1}(w) = P^T M_l(w prolonged to level l's cells) P,

and the right-hand side and QoI functionals are restricted by P^T. The
per-(cell, axis) coarse blocks are read off two products: with w the
indicator of the cells of one colour of a 3D checkerboard, no two cells
of the colour share a face, so the assembled entries on a cell's faces
are that cell's block.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp

from .mixed import Level, parent_1d


def _agg_matrix(par: np.ndarray, n_c: int) -> np.ndarray:
    R = np.zeros((n_c, par.size))
    R[par, np.arange(par.size)] = 1.0
    return R


def line_weights(fine: Level, coarse: Level, blocks) -> List[np.ndarray]:
    """Per axis a: alpha on the grid (transverse fine dims in array order,
    coarse faces along a last)."""
    bll, blr, brr = blocks
    d = fine.d
    rshape = fine.shape[::-1]
    out = []
    for a in range(d):
        dim = d - 1 - a
        r = (bll[:, a] + 2.0 * blr[:, a] + brr[:, a]).reshape(rshape)
        r = np.moveaxis(r, dim, -1)  # (transverse..., n_f_a)
        n_c = coarse.shape[a]
        S = r @ _agg_matrix(parent_1d(fine.axes[a], coarse.axes[a]), n_c).T
        R = np.empty(S.shape[:-1] + (n_c + 1,))
        R[..., 0] = S[..., 0]
        R[..., -1] = S[..., -1]
        R[..., 1:-1] = S[..., :-1] + S[..., 1:]
        c = 1.0 / R
        # Sum over the fine lines of each coarse transverse cell, gather back.
        den = c
        tdims = [b for b in range(d - 1, -1, -1) if b != a]  # mesh axes in array order
        for i, b in enumerate(tdims):
            par = parent_1d(fine.axes[b], coarse.axes[b])
            Rb = _agg_matrix(par, coarse.shape[b])
            den = np.moveaxis(np.moveaxis(den, i, -1) @ Rb.T, -1, i)
            den = np.take(den, par, axis=i)
        out.append(c / den)
    return out


def prolongator(fine: Level, coarse: Level, alpha: List[np.ndarray]) -> sp.csr_matrix:
    """The coarse-to-fine face embedding with line weights alpha."""
    d = fine.d
    rows, cols, vals = [], [], []
    for a in range(d):
        dim = d - 1 - a
        fs = fine.face_shape[a]
        fid = fine.face_off[a] + np.arange(int(np.prod(fs))).reshape(fs)
        fid = np.moveaxis(fid, dim, -1)  # (transverse..., n_f_a + 1)
        x = fine.axes[a]
        J = np.clip(np.searchsorted(coarse.axes[a], x), 0, coarse.axes[a].size - 1)
        on = np.abs(coarse.axes[a][J] - x) <= 1e-9 * max(1.0, abs(x[-1]))
        cell = np.searchsorted(coarse.axes[a], x, side="right") - 1
        cell = np.clip(cell, 0, coarse.shape[a] - 1)
        t = (x - coarse.axes[a][cell]) / (coarse.axes[a][cell + 1] - coarse.axes[a][cell])
        # Coarse face ids on (coarse transverse cell of each fine line, J).
        cfs = coarse.face_shape[a]
        cid = coarse.face_off[a] + np.arange(int(np.prod(cfs))).reshape(cfs)
        cid = np.moveaxis(cid, dim, -1)
        tdims = [b for b in range(d - 1, -1, -1) if b != a]
        for i, b in enumerate(tdims):
            cid = np.take(cid, parent_1d(fine.axes[b], coarse.axes[b]), axis=i)
        # cid: (transverse fine..., n_c_a + 1); alpha[a] has the same shape.
        al = alpha[a]
        for i_line in range(x.size):
            if on[i_line]:
                rows.append(fid[..., i_line].ravel())
                cols.append(cid[..., J[i_line]].ravel())
                vals.append(al[..., J[i_line]].ravel())
            else:
                j = cell[i_line]
                for off, wt in ((0, 1.0 - t[i_line]), (1, t[i_line])):
                    rows.append(fid[..., i_line].ravel())
                    cols.append(cid[..., j + off].ravel())
                    vals.append(wt * al[..., j + off].ravel())
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(fine.n_u, coarse.n_u))


def cell_parent(fine: Level, coarse: Level) -> np.ndarray:
    """(n_s fine,) coarse cell of each fine cell."""
    idx = np.zeros(fine.shape[::-1], dtype=np.int64)
    stride = 1
    for a in range(fine.d):
        par = parent_1d(fine.axes[a], coarse.axes[a])
        shape = [1] * fine.d
        shape[fine.d - 1 - a] = -1
        idx = idx + par.reshape(shape) * stride
        stride *= coarse.shape[a]
    return idx.reshape(-1)


def coarse_blocks(fine: Level, coarse: Level, blocks, P: sp.csr_matrix):
    """Per-(cell, axis) blocks of P^T M_fine(w) P, by the checkerboard."""
    d = coarse.d
    par = cell_parent(fine, coarse)
    grid = np.indices(coarse.shape[::-1]).sum(axis=0).reshape(-1) % 2
    bll = np.zeros((coarse.n_s, d))
    blr = np.zeros((coarse.n_s, d))
    brr = np.zeros((coarse.n_s, d))
    for colour in (0, 1):
        wc = (grid == colour).astype(np.float64)
        A = (P.T @ fine.mass_matrix(blocks, wc[par]) @ P).tocsr()
        cells = np.nonzero(grid == colour)[0]
        for a in range(d):
            lo, hi = coarse.cell_lo[a][cells], coarse.cell_hi[a][cells]
            bll[cells, a] = np.asarray(A[lo, lo]).ravel()
            blr[cells, a] = np.asarray(A[lo, hi]).ravel()
            brr[cells, a] = np.asarray(A[hi, hi]).ravel()
    return bll, blr, brr


def galerkin_chain(levels: List[Level], kinv: np.ndarray):
    """(blocks per level, prolongators per coarsening)."""
    chain = [levels[0].plain_blocks(kinv)]
    Ps = []
    for l in range(len(levels) - 1):
        alpha = line_weights(levels[l], levels[l + 1], chain[l])
        P = prolongator(levels[l], levels[l + 1], alpha)
        Ps.append(P)
        chain.append(coarse_blocks(levels[l], levels[l + 1], chain[l], P))
    return chain, Ps
