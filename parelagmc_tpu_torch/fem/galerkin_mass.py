"""Galerkin (energy-consistent) coarse RT0 velocity mass operators.

The reference's coarse Darcy levels inherit the FINE operator: ParELAG's
AMGe coarsening RAPs agglomerate-local element matrices through the coarse
de Rham bases, and the per-sample coefficient multiplies those coarse
element matrices (ParELAGMC src/DarcySolver.cpp:161-169 Coarsen();
per-sample rescaling :586-591). Round 2 instead *rediscretized* every coarse
level with a volume-averaged (arithmetic in kinv = harmonic in k) coarse
coefficient, which at SPE10's ~1e6 contrast defines a materially different
coarse problem - the measured cause of the missing MLMC variance decay
(VERDICT r2 item 1; examples/spe10_rate_diagnostics.py).

This module computes the exact Galerkin coarse mass

    M_c(w_c) = sum_T w_c[T] * P_rt^T M_f^(T)(kinv_ref) P_rt,

with M_f^(T) the fine kinv-weighted mass restricted to fine cells of coarse
cell T, and w_c the per-sample piecewise-constant coarse field. Because the
RT embedding on tensor grids preserves the axis and the transverse index
(fem/hierarchy.rt_prolongator), the coarse matrix keeps the fine matrix's
exact sparsity *and* coefficient structure: per (cell, axis) a symmetric
2x2 block on the cell's (lo, hi) faces,

    [[bll, blr], [blr, brr]],

which degenerates to the rediscretized (m3, m6, m3) * kinv_c values when
kinv_ref is constant inside every coarse cell (the RT embedding is exact,
so unit-coefficient RAP == rediscretization - oracle-tested). The blocks
drive both the CoefELL device operator and the exact tridiagonal
M(w)^{-1} line solver (ops/mass_solve.py), so the entire fast-solver stack
survives the switch to energy-consistent coarse levels unchanged.

The port's own copy of parelagmc_tpu/fem/galerkin_mass.py (host-side numpy and scipy, as
there): the port imports nothing of the JAX package. It keeps only
what the port calls (no ELL value slabs, no scipy oracle).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from parelagmc_tpu_torch.fem.assembly import MixedLevel
from parelagmc_tpu_torch.mesh.structured import StructuredMesh


def fine_axis_blocks(
    mesh: StructuredMesh, kinv: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(cell, axis) 2x2 mass blocks of the fine level: bll = brr =
    h_a^2/(3V) * kinv[:, a], blr = h_a^2/(6V) * kinv[:, a]."""
    d = mesh.dim
    n_s = mesh.num_cells
    vol = mesh.cell_volumes()
    bll = np.zeros((n_s, d))
    blr = np.zeros((n_s, d))
    for a in range(d):
        h = mesh.cell_widths(a)
        m3 = h * h / (3.0 * vol)
        bll[:, a] = m3
        blr[:, a] = 0.5 * m3
    if kinv is not None:
        k = np.asarray(kinv, dtype=np.float64)
        if k.ndim == 1:
            k = np.repeat(k[:, None], d, axis=1)
        bll = bll * k
        blr = blr * k
    return bll, blr, bll.copy()


def adapted_line_weights(
    fine: StructuredMesh,
    coarse: StructuredMesh,
    blocks: Tuple[np.ndarray, np.ndarray, np.ndarray],
) -> List[np.ndarray]:
    """Energy-minimal per-line flux weights of the coarse RT basis.

    The reference's AMGe coarse H(div) bases are minimum-energy extensions
    with respect to the kinv-weighted fine mass (the DeRhamSequence is
    built with the InversePermeability mass integrator,
    ParELAGMC src/DarcySolver.cpp:87-90 ReplaceMassIntegrator +
    :161-169 Coarsen), so coarse flux channels through high-permeability
    paths. The tensor-structured analog restricts the basis of an axis-a
    coarse face to axis-a fine faces with a per-fine-line weight alpha
    (uniform-divergence linear profile along the line); minimizing the
    kinv-energy over the weights gives the parallel-conductance rule

        alpha_line(F) = c_line / sum_lines c_line,
        c_line = 1 / (sum over the serial chain of cells behind+ahead of F
                      along the line of r_cell),  r_cell = bll + 2 blr + brr

    (r_cell is exactly the energy of a unit uniform flux through the cell:
    kinv * h / A on the fine level, and the self-consistent generalization
    at deeper levels where the blocks are already RAPed). For constant kinv
    this reduces to the transverse area fraction, i.e. the geometric
    embedding of fem/hierarchy.rt_prolongator. Returned per axis as the
    grid alpha[transverse fine lines..., coarse face index] in array
    (reversed) layout with the axis last."""
    from parelagmc_tpu_torch.fem.hierarchy import axis_parent_map

    d = fine.dim
    bll, blr, brr = blocks
    rshape = fine.shape[::-1]
    maps = [axis_parent_map(fine.axes[a], coarse.axes[a]) for a in range(d)]
    out = []
    for a in range(d):
        r = (bll[:, a] + 2.0 * blr[:, a] + brr[:, a]).reshape(rshape)
        dim_a = d - 1 - a
        perm = tuple(i for i in range(d) if i != dim_a) + (dim_a,)
        r = np.transpose(r, perm)  # (transverse..., n_f_a)
        n_c_a = coarse.shape[a]
        pj = maps[a]
        # Serial resistance of each line segment inside each coarse cell.
        S = np.stack(
            [r[..., pj == j].sum(axis=-1) for j in range(n_c_a)], axis=-1
        )
        # Chain resistance per coarse face (one-sided at the boundary).
        R = np.empty(r.shape[:-1] + (n_c_a + 1,))
        R[..., 0] = S[..., 0]
        R[..., -1] = S[..., -1]
        if n_c_a > 1:
            R[..., 1:-1] = S[..., :-1] + S[..., 1:]
        c = 1.0 / np.maximum(R, 1e-300)
        # Normalize over the lines of each coarse transverse cell: sum the
        # conductances into the coarse transverse grid, then gather back.
        # After the perm, array dims 0..d-2 are the mesh axes in DESCENDING
        # order excluding a (reversed layout).
        tax = [b for b in range(d - 1, -1, -1) if b != a]
        denom = c
        for i, b in enumerate(tax):
            pb = maps[b]
            denom = np.stack(
                [
                    denom.take(np.nonzero(pb == J)[0], axis=i).sum(axis=i)
                    for J in range(coarse.shape[b])
                ],
                axis=i,
            )
        for i, b in enumerate(tax):
            denom = denom.take(maps[b], axis=i)
        out.append(c / np.maximum(denom, 1e-300))
    return out


def coarsen_axis_blocks(
    fine: StructuredMesh,
    coarse: StructuredMesh,
    blocks: Tuple[np.ndarray, np.ndarray, np.ndarray],
    weights: Optional[List[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One RAP step: fine per-cell blocks -> coarse per-cell blocks.

    For fine cell k in coarse cell T, the RT embedding restricted to k's two
    axis-a faces is E = [[(1-t0) a_lo, t0 a_hi], [(1-t1) a_lo, t1 a_hi]],
    with t0/t1 the relative along-axis positions of k's faces inside T and
    a_lo/a_hi the flux weights of k's fine line at T's lo/hi coarse faces -
    the transverse area fraction for the geometric embedding
    (weights=None), or the energy-minimal conductance weights of
    adapted_line_weights. The coarse block of T accumulates E^T B_k E.
    Handles any nested (non-dyadic) coarsening, e.g. SPE10's 85 -> 43
    z-layers."""
    from parelagmc_tpu_torch.fem.hierarchy import axis_parent_map

    d = fine.dim
    bll, blr, brr = blocks
    idx = fine.cell_multi_index()
    maps = [axis_parent_map(fine.axes[a], coarse.axes[a]) for a in range(d)]
    par = coarse.cell_index(*[m[i] for m, i in zip(maps, idx)])
    # Per-axis width ratios of each fine cell vs its parent.
    frac = []
    for a in range(d):
        wf = np.diff(fine.axes[a])[idx[a]]
        wc = np.diff(coarse.axes[a])[maps[a][idx[a]]]
        frac.append(wf / wc)
    n_c = coarse.num_cells
    out_ll = np.zeros((n_c, d))
    out_lr = np.zeros((n_c, d))
    out_rr = np.zeros((n_c, d))
    rshape = fine.shape[::-1]
    for a in range(d):
        i_a = idx[a]
        j_a = maps[a][i_a]
        xk_lo = fine.axes[a][i_a]
        xk_hi = fine.axes[a][i_a + 1]
        x_lo = coarse.axes[a][j_a]
        x_hi = coarse.axes[a][j_a + 1]
        t0 = (xk_lo - x_lo) / (x_hi - x_lo)
        t1 = (xk_hi - x_lo) / (x_hi - x_lo)
        if weights is None:
            af = np.ones(len(par))
            for b in range(d):
                if b != a:
                    af = af * frac[b]
            a_lo = a_hi = af
        else:
            a_lo, a_hi = cell_face_weights(fine, maps, weights, a, idx, j_a)
        e00, e01 = (1.0 - t0) * a_lo, t0 * a_hi
        e10, e11 = (1.0 - t1) * a_lo, t1 * a_hi
        B00, B01, B11 = bll[:, a], blr[:, a], brr[:, a]
        c_ll = e00 * (B00 * e00 + B01 * e10) + e10 * (B01 * e00 + B11 * e10)
        c_lr = e00 * (B00 * e01 + B01 * e11) + e10 * (B01 * e01 + B11 * e11)
        c_rr = e01 * (B00 * e01 + B01 * e11) + e11 * (B01 * e01 + B11 * e11)
        np.add.at(out_ll[:, a], par, c_ll)
        np.add.at(out_lr[:, a], par, c_lr)
        np.add.at(out_rr[:, a], par, c_rr)
    return out_ll, out_lr, out_rr


def cell_face_weights(
    fine: StructuredMesh,
    maps: List[np.ndarray],
    weights: List[np.ndarray],
    a: int,
    idx: List[np.ndarray],
    j_a: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-fine-cell (a_lo, a_hi): the flux weight of the cell's fine line
    at its parent's lo/hi coarse face along axis a (flat cell order)."""
    d = fine.dim
    alpha = weights[a]  # (transverse fine..., n_c_a + 1), axis-a last
    # Transverse index of each fine cell into alpha's leading dims: the
    # perm in adapted_line_weights keeps the reversed-layout order of the
    # non-a dims, i.e. mesh axes descending excluding a.
    trans_axes = [b for b in range(d - 1, -1, -1) if b != a]
    lead = tuple(idx[b] for b in trans_axes)
    a_lo = alpha[lead + (j_a,)]
    a_hi = alpha[lead + (j_a + 1,)]
    return a_lo, a_hi


def galerkin_block_chain(
    meshes: List[StructuredMesh],
    kinv_fine: Optional[np.ndarray],
    adapt: bool = True,
) -> Tuple[
    List[Tuple[np.ndarray, np.ndarray, np.ndarray]], List[Optional[List[np.ndarray]]]
]:
    """Blocks + prolongator line weights for every level: level 0
    rediscretized (it IS the fine operator), each coarser level the RAP of
    the previous through the energy-minimal adapted embedding (adapt=True;
    None weights = geometric area-fraction embedding). Returns
    (blocks_per_level, weights_per_coarsening_step)."""
    chain = [fine_axis_blocks(meshes[0], kinv_fine)]
    weights: List[Optional[List[np.ndarray]]] = []
    for l in range(len(meshes) - 1):
        w = (
            adapted_line_weights(meshes[l], meshes[l + 1], chain[l])
            if adapt
            else None
        )
        weights.append(w)
        chain.append(
            coarsen_axis_blocks(meshes[l], meshes[l + 1], chain[l], weights=w)
        )
    return chain, weights


def weighted_rt_prolongator(
    fine: StructuredMesh,
    coarse: StructuredMesh,
    weights: List[np.ndarray],
):
    """Sparse coarse->fine RT embedding with per-line flux weights (the
    energy-adapted replacement of fem/hierarchy.rt_prolongator, which this
    reproduces exactly when the weights are the transverse area
    fractions). Used to restrict rhs/QoI functionals consistently with the
    adapted coarse operators."""
    import scipy.sparse as sp

    from parelagmc_tpu_torch.fem.hierarchy import axis_parent_map

    d = fine.dim
    tol = 1e-12
    maps = [axis_parent_map(fine.axes[a], coarse.axes[a]) for a in range(d)]
    rows, cols, vals = [], [], []
    for a in range(d):
        alpha = weights[a]  # (trans fine..., n_c_a + 1)
        tax = [b for b in range(d - 1, -1, -1) if b != a]
        shape_f = fine.face_grid_shape(a)
        grids = np.meshgrid(
            *[np.arange(s, dtype=np.int64) for s in shape_f], indexing="ij"
        )
        idx_f = [g.ravel(order="F") for g in grids]
        fidx = fine.face_index(a, *idx_f)
        trans_lead = tuple(idx_f[b] for b in tax)
        cidx_trans = [
            (maps[b][idx_f[b]] if b != a else None) for b in range(d)
        ]
        x = fine.axes[a][idx_f[a]]
        j = np.searchsorted(coarse.axes[a], x, side="left")
        j = np.clip(j, 0, coarse.axes[a].size - 1)
        on_plane = np.abs(coarse.axes[a][j] - x) <= tol
        # -- faces on coarse planes: weight alpha(line, j) -------------------
        sel = on_plane
        cidx = [(j[sel] if b == a else cidx_trans[b][sel]) for b in range(d)]
        rows.append(fidx[sel])
        cols.append(coarse.face_index(a, *cidx))
        vals.append(alpha[tuple(t[sel] for t in trans_lead) + (j[sel],)])
        # -- interior faces: blend of the parent cell's two coarse faces -----
        sel = ~on_plane
        cell_j = np.searchsorted(coarse.axes[a], x[sel], side="left") - 1
        x_lo = coarse.axes[a][cell_j]
        x_hi = coarse.axes[a][cell_j + 1]
        t = (x[sel] - x_lo) / (x_hi - x_lo)
        lead_sel = tuple(tt[sel] for tt in trans_lead)
        for off, wt in ((0, 1.0 - t), (1, t)):
            cidx = [
                ((cell_j + off) if b == a else cidx_trans[b][sel])
                for b in range(d)
            ]
            rows.append(fidx[sel])
            cols.append(coarse.face_index(a, *cidx))
            vals.append(wt * alpha[lead_sel + (cell_j + off,)])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(fine.num_faces, coarse.num_faces),
    )


def blocks_to_ell_vals(
    lvl: MixedLevel, blocks: Tuple[np.ndarray, np.ndarray, np.ndarray]
) -> np.ndarray:
    """Coefficient-ELL value slab for the block mass on `lvl`'s mesh, in the
    exact slot layout of fem/assembly.build_mixed_level (diag-from-lo-cell,
    diag-from-hi-cell, off-to-lo-face, off-to-hi-face)."""
    bll, blr, brr = blocks
    ax = lvl.mesh.face_axis()
    nz = lvl.m_vals != 0.0
    vals = np.zeros_like(lvl.m_vals)
    cells = lvl.m_cells
    # Slot 0: face is the HI face of the lo-adjacent cell -> brr.
    vals[:, 0] = brr[cells[:, 0], ax]
    # Slot 1: face is the LO face of the hi-adjacent cell -> bll.
    vals[:, 1] = bll[cells[:, 1], ax]
    vals[:, 2] = blr[cells[:, 2], ax]
    vals[:, 3] = blr[cells[:, 3], ax]
    return vals * nz


def effective_kinv(
    mesh: StructuredMesh, blocks: Tuple[np.ndarray, np.ndarray, np.ndarray]
) -> np.ndarray:
    """Per-(cell, axis) effective inverse permeability of the block mass:
    the coefficient whose rediscretized mass matches the Galerkin block
    diagonal, k_eff = (bll + brr) / (2 * h^2/(3V)). Feeds the
    preconditioner scalings (S(1) geometric-mean / local scaling and the
    static Schur MG assembly), keeping them first-order consistent with
    the energy-consistent operator they precondition."""
    bll, _, brr = blocks
    d = mesh.dim
    vol = mesh.cell_volumes()
    out = np.zeros_like(bll)
    for a in range(d):
        h = mesh.cell_widths(a)
        m3 = h * h / (3.0 * vol)
        out[:, a] = (bll[:, a] + brr[:, a]) / (2.0 * m3)
    return np.maximum(out, 1e-300)
