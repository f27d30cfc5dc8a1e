"""Geometric multilevel hierarchy of mixed RT0/P0 levels.

The reference obtains coarse de Rham spaces by AMGe agglomeration (ParELAG
DeRhamSequence::Coarsen, driven from src/PDESampler.cpp:160-168 and
src/DarcySolver.cpp:161-169); on uniformly-refined structured meshes with
the default constant targets, the coarse spaces have exactly the dof counts
of the geometrically coarsened mesh (golden test: 17152/2240/304 dofs,
examples/CMakeLists.txt:62-66). We build the hierarchy geometrically: level
L-1 is the base (coarsest) mesh and each finer level is a uniform
refinement; every level is *re-discretized* (its own exact RT0/P0
operators), and the interlevel transfer operators are the exact finite
element embeddings:

* P_l2 (P0): fine cell value = parent coarse cell value (injection). Stored
  as the parent map; P^T is a segment sum.
* P_rt (RT0): the natural embedding of a coarse RT0 field in the fine space.
  On boxes the RT0 normal component is constant on planes normal to its
  axis, so a fine face lying *on* a coarse face carries 1/2^(d-1) of the
  coarse flux, and a fine face on a coarse cell's mid-plane carries
  1/2^d of each of the two parallel coarse faces of that cell. These are
  exact (the embedding reproduces the coarse field), so the de Rham diagram
  commutes: Div_f P_rt = P_l2 Div_c - tested in tests/test_fem.py.

Level ordering follows the reference: level 0 = finest.

The port's own copy of parelagmc_tpu/fem/hierarchy.py (host-side numpy and scipy, as
there): the port imports nothing of the JAX package. It keeps only
what the port calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import scipy.sparse as sp

from parelagmc_tpu_torch.fem.assembly import MixedLevel, build_mixed_level
from parelagmc_tpu_torch.mesh.structured import StructuredMesh


@dataclass
class GeometricHierarchy:
    levels: List[MixedLevel]  # [0] = finest
    parent: List[np.ndarray]  # parent[l]: fine cell -> coarse cell (level l -> l+1)
    P_rt: List[sp.csr_matrix]  # P_rt[l]: (n_u[l], n_u[l+1]) coarse -> fine

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    def p_l2(self, l: int) -> sp.csr_matrix:
        ne_f = self.levels[l].n_s
        return sp.csr_matrix(
            (np.ones(ne_f), (np.arange(ne_f), self.parent[l])),
            shape=(ne_f, self.levels[l + 1].n_s),
        )


def axis_parent_map(fine_axis: np.ndarray, coarse_axis: np.ndarray) -> np.ndarray:
    """(n_fine_cells,) coarse cell index containing each fine cell along one
    axis; the coarse grid lines must be a subset of the fine ones."""
    centers = 0.5 * (fine_axis[1:] + fine_axis[:-1])
    j = np.searchsorted(coarse_axis, centers) - 1
    assert np.all(j >= 0) and np.all(j < coarse_axis.size - 1)
    return j.astype(np.int64)


def rt_prolongator(fine: StructuredMesh, coarse: StructuredMesh) -> sp.csr_matrix:
    """Exact RT0 embedding matrix P: coarse face dofs -> fine face dofs.

    Works for any nested structured coarsening (coarse grid lines a subset
    of fine grid lines, arbitrary per-axis grouping - not just dyadic):
    on a coarse face plane, the coarse normal component is constant, so a
    fine sub-face carries the transverse area fraction of the coarse flux;
    on an interior plane at relative position t within the coarse cell, it
    carries the area fraction of the linear blend (1-t)*F_lo + t*F_hi.
    """
    d = fine.dim
    tol = 1e-12
    parent = [axis_parent_map(fine.axes[a], coarse.axes[a]) for a in range(d)]
    # Per-axis transverse area fraction factors: fine cell width / coarse
    # parent cell width.
    frac = []
    for a in range(d):
        wf = np.diff(fine.axes[a])
        wc = np.diff(coarse.axes[a])
        frac.append(wf / wc[parent[a]])
    rows, cols, vals = [], [], []
    for a in range(d):
        shape_f = fine.face_grid_shape(a)
        grids = np.meshgrid(
            *[np.arange(s, dtype=np.int64) for s in shape_f], indexing="ij"
        )
        idx_f = [g.ravel(order="F") for g in grids]
        fidx = fine.face_index(a, *idx_f)
        # Transverse area fraction (product over other axes).
        area_frac = np.ones(fidx.size)
        cidx_trans = []
        for ax in range(d):
            if ax == a:
                cidx_trans.append(None)
                continue
            area_frac = area_frac * frac[ax][idx_f[ax]]
            cidx_trans.append(parent[ax][idx_f[ax]])
        # Along-axis position of each fine face's grid line.
        x = fine.axes[a][idx_f[a]]
        j = np.searchsorted(coarse.axes[a], x, side="left")
        j = np.clip(j, 0, coarse.axes[a].size - 1)
        on_plane = np.abs(coarse.axes[a][j] - x) <= tol
        # -- faces on coarse planes: child of coarse face j ------------------
        sel = on_plane
        cidx = [
            (j[sel] if ax == a else cidx_trans[ax][sel]) for ax in range(d)
        ]
        rows.append(fidx[sel])
        cols.append(coarse.face_index(a, *cidx))
        vals.append(area_frac[sel])
        # -- interior faces: blend of the parent cell's two coarse faces ------
        sel = ~on_plane
        cell_j = np.searchsorted(coarse.axes[a], x[sel], side="left") - 1
        x_lo = coarse.axes[a][cell_j]
        x_hi = coarse.axes[a][cell_j + 1]
        t = (x[sel] - x_lo) / (x_hi - x_lo)
        for off, wt in ((0, 1.0 - t), (1, t)):
            cidx = [
                ((cell_j + off) if ax == a else cidx_trans[ax][sel])
                for ax in range(d)
            ]
            rows.append(fidx[sel])
            cols.append(coarse.face_index(a, *cidx))
            vals.append(area_frac[sel] * wt)
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(fine.num_faces, coarse.num_faces),
    )


def _finish(meshes: List[StructuredMesh]) -> GeometricHierarchy:
    nlevels = len(meshes)
    levels = [build_mixed_level(m) for m in meshes]
    parent = []
    for l in range(nlevels - 1):
        maps = [
            axis_parent_map(meshes[l].axes[a], meshes[l + 1].axes[a])
            for a in range(meshes[l].dim)
        ]
        idx = meshes[l].cell_multi_index()
        parent.append(meshes[l + 1].cell_index(*[m[i] for m, i in zip(maps, idx)]))
    P_rt = [rt_prolongator(meshes[l], meshes[l + 1]) for l in range(nlevels - 1)]
    return GeometricHierarchy(levels=levels, parent=parent, P_rt=P_rt)


def build_geometric_hierarchy(
    base_mesh: StructuredMesh, nlevels: int
) -> GeometricHierarchy:
    """Build `nlevels` levels with `base_mesh` as the coarsest (level
    nlevels-1), refining uniformly toward level 0."""
    meshes = [base_mesh]
    for _ in range(nlevels - 1):
        meshes.append(meshes[-1].refine())
    return _finish(meshes[::-1])


def derefine_axis(axis: np.ndarray, factor: int = 2) -> np.ndarray:
    """Coarse axis: every `factor`-th grid line, always keeping the last
    (trailing cells merge into the final coarse cell when the count is not
    divisible - how SPE10's 85 z-layers coarsen to 42). A 1-cell axis is
    already as coarse as it gets and passes through unchanged."""
    if axis.size <= 2:
        return np.asarray(axis)
    coarse = list(axis[::factor])
    if coarse[-1] != axis[-1]:
        coarse[-1] = axis[-1]  # merge trailing fine cells into the last group
    return np.asarray(coarse)


def build_geometric_hierarchy_from_fine(
    fine_mesh: StructuredMesh, nlevels: int, factor: int = 2
) -> GeometricHierarchy:
    """Build `nlevels` levels with `fine_mesh` as level 0, derefining by
    `factor` per axis toward the coarsest level. Handles odd cell counts
    (the trailing cells merge into the last coarse cell), so grids like
    SPE10's 60x220x85 coarsen without truncation - this replaces the
    reference's METIS agglomeration (src/Utilities.cpp:125-155) for tensor
    grids; unstructured meshes use fem/agglomeration.py instead."""
    meshes = [fine_mesh]
    for _ in range(nlevels - 1):
        prev = meshes[-1]
        coarse = StructuredMesh([derefine_axis(a, factor) for a in prev.axes])
        # Attributes: majority vote is overkill; carry the attribute of the
        # first child (embedded meshes coarsen consistently when the buffer
        # width divides the coarsening).
        maps = [
            axis_parent_map(prev.axes[a], coarse.axes[a]) for a in range(prev.dim)
        ]
        idx = prev.cell_multi_index()
        par = coarse.cell_index(*[m[i] for m, i in zip(maps, idx)])
        attrs = np.ones(coarse.num_cells, dtype=np.int32)
        attrs[par] = prev.attributes
        coarse.attributes = attrs
        meshes.append(coarse)
    return _finish(meshes)
