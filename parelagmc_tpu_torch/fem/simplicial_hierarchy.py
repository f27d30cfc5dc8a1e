"""Nested multilevel hierarchies on unstructured simplicial meshes.

The port's copy of parelagmc_tpu/fem/simplicial_hierarchy.py (numpy/scipy).

Gives the unstructured path (fem/simplicial.py) real MLMC levels: uniform
midpoint refinement of triangles (4 children) and tetrahedra (8 children,
octasection with a fixed diagonal) generates nested RT0/P0 spaces, so the
interlevel transfers are exact finite element embeddings just like the
structured path:

* P_l2: fine cell value = parent value (parent maps from construction).
* P_rt: flux of the embedded coarse field through each fine face. RT0 on a
  simplex is linear, so the flux is area * (phi(centroid) . n) exactly;
  each fine face takes its contribution from its owner cell's parent (the
  normal flux of an H(div) field is single-valued across interfaces).

Relation to the reference: the reference builds coarse levels by
agglomerating a *given* fine unstructured mesh with METIS + AMGe coarse
bases (src/Utilities.cpp:125-155); here the hierarchy grows by refining the
given mesh instead - the same nested-space MLMC structure with exact
transfer operators. The agglomerating alternative (coarsening the given
mesh in place, minimum-energy coarse RT bases) is fem/agglomeration.py.

Verified invariants (tests/test_unstructured_ml.py): P^T M_f P == M_c,
commuting divergence diagram, P^T W_f P == W_c.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from parelagmc_tpu_torch.fem.simplicial import SimplicialLevel, build_simplicial_level
from parelagmc_tpu_torch.mesh.mfem_io import GeneralMesh


def refine_simplicial(gm: GeneralMesh) -> Tuple[GeneralMesh, np.ndarray]:
    """Uniform midpoint refinement. Returns (fine mesh, parent cell map)."""
    d = gm.dim
    conn = np.stack(gm.elements)
    ne = conn.shape[0]
    verts = gm.vertices
    nv = verts.shape[0]

    # Unique edges -> midpoint vertex ids.
    nloc = d + 1
    pairs = [(i, j) for i in range(nloc) for j in range(i + 1, nloc)]
    edges = np.sort(
        np.stack([conn[:, [i, j]] for (i, j) in pairs], axis=1).reshape(-1, 2),
        axis=1,
    )
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid_ids = nv + np.arange(uniq.shape[0])
    new_verts = np.concatenate(
        [verts, 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])], axis=0
    )
    # mid[e, k] = vertex id of the midpoint of local edge k.
    mid = mid_ids[inv].reshape(ne, len(pairs))

    def m(e_cols, i, j):
        k = pairs.index((min(i, j), max(i, j)))
        return mid[:, k]

    els: List[np.ndarray] = []
    parents: List[np.ndarray] = []
    if d == 2:
        v0, v1, v2 = conn[:, 0], conn[:, 1], conn[:, 2]
        m01, m02, m12 = m(conn, 0, 1), m(conn, 0, 2), m(conn, 1, 2)
        children = [
            np.stack([v0, m01, m02], 1),
            np.stack([m01, v1, m12], 1),
            np.stack([m02, m12, v2], 1),
            np.stack([m01, m12, m02], 1),
        ]
    else:
        v0, v1, v2, v3 = (conn[:, i] for i in range(4))
        m01, m02, m03 = m(conn, 0, 1), m(conn, 0, 2), m(conn, 0, 3)
        m12, m13, m23 = m(conn, 1, 2), m(conn, 1, 3), m(conn, 2, 3)
        children = [
            np.stack([v0, m01, m02, m03], 1),
            np.stack([v1, m01, m12, m13], 1),
            np.stack([v2, m02, m12, m23], 1),
            np.stack([v3, m03, m13, m23], 1),
            # Octahedron split along the fixed diagonal (m01, m23).
            np.stack([m01, m23, m02, m12], 1),
            np.stack([m01, m23, m12, m13], 1),
            np.stack([m01, m23, m13, m03], 1),
            np.stack([m01, m23, m03, m02], 1),
        ]
    nchild = len(children)
    fine_conn = np.stack(children, axis=1).reshape(ne * nchild, d + 1)
    parent = np.repeat(np.arange(ne), nchild)

    # Refine boundary faces (attribute-preserving).
    boundary: List[np.ndarray] = []
    battr: List[int] = []
    if gm.boundary:
        bconn = np.stack(gm.boundary)
        bpairs = [(i, j) for i in range(d) for j in range(i + 1, d)]
        bedges = np.sort(
            np.stack([bconn[:, [i, j]] for (i, j) in bpairs], axis=1).reshape(-1, 2),
            axis=1,
        )
        # Look up the midpoints created above.
        from parelagmc_tpu_torch.fem.simplicial import _rows_lookup

        pos = _rows_lookup(uniq, bedges)
        assert np.all(pos >= 0), "boundary edge missing from element edges"
        bmid = mid_ids[pos].reshape(bconn.shape[0], len(bpairs))
        if d == 2:  # boundary = segments -> 2 children
            kids = [
                np.stack([bconn[:, 0], bmid[:, 0]], 1),
                np.stack([bmid[:, 0], bconn[:, 1]], 1),
            ]
        else:  # boundary = triangles -> 4 children
            b01, b02, b12 = bmid[:, 0], bmid[:, 1], bmid[:, 2]
            kids = [
                np.stack([bconn[:, 0], b01, b02], 1),
                np.stack([b01, bconn[:, 1], b12], 1),
                np.stack([b02, b12, bconn[:, 2]], 1),
                np.stack([b01, b12, b02], 1),
            ]
        for k in kids:
            boundary.extend(list(k))
            battr.extend(list(gm.boundary_attributes))

    geom = 2 if d == 2 else 4
    fine = GeneralMesh(
        dim=d,
        vertices=new_verts,
        elements=list(fine_conn),
        attributes=gm.attributes[parent],
        geom_types=np.full(ne * nchild, geom, dtype=np.int32),
        boundary=boundary,
        boundary_attributes=np.asarray(battr, dtype=np.int32),
    )
    return fine, parent


def rt_prolongator_simplicial(
    fine: SimplicialLevel, coarse: SimplicialLevel, parent: np.ndarray
) -> sp.csr_matrix:
    """Exact RT0 embedding P: coarse face dofs -> fine face dofs."""
    d = fine.mesh.dim
    conn_f = np.stack(fine.mesh.elements)
    conn_c = np.stack(coarse.mesh.elements)
    verts_f = fine.mesh.vertices
    verts_c = coarse.mesh.vertices
    nloc = d + 1
    local_faces = [[j for j in range(nloc) if j != i] for i in range(nloc)]

    # Fine face geometry from the owner cell: centroid, area, owner-outward
    # unit normal.
    n_uf = fine.n_u
    centroid = np.zeros((n_uf, d))
    area = np.zeros(n_uf)
    normal = np.zeros((n_uf, d))
    owner = fine.face_cells[:, 0]
    for i, lf in enumerate(local_faces):
        fids = fine.cell_faces[:, i]
        is_owner = owner[fids] == np.arange(conn_f.shape[0])
        q = verts_f[conn_f[:, lf]]
        cen = q.mean(axis=1)
        opp = verts_f[conn_f[:, i]]
        if d == 2:
            t = q[:, 1] - q[:, 0]
            nvec = np.stack([t[:, 1], -t[:, 0]], axis=1)
            a = np.linalg.norm(t, axis=1)
        else:
            nvec = 0.5 * np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
            a = np.linalg.norm(nvec, axis=1)
        nunit = nvec / np.linalg.norm(nvec, axis=1)[:, None]
        outward = np.sign(np.einsum("ed,ed->e", cen - opp, nunit))
        nunit = nunit * outward[:, None]
        sel = fids[is_owner]
        centroid[sel] = cen[is_owner]
        area[sel] = a[is_owner]
        normal[sel] = nunit[is_owner]

    # Coarse cell data.
    import math as _math

    p_c = verts_c[conn_c]  # (nec, d+1, d)
    vol_c = np.abs(np.linalg.det(p_c[:, 1:] - p_c[:, :1])) / _math.factorial(d)

    # For each fine face: parent coarse cell of the owner fine cell.
    pc = parent[owner]  # (n_uf,)
    rows, cols, vals = [], [], []
    for i in range(nloc):
        # Coarse basis i of cell pc: phi = sign_i (x - p_i) / (d vol).
        sign_i = coarse.cell_signs[pc, i]
        opp = verts_c[conn_c[pc, i]]
        coef = sign_i / (d * vol_c[pc])
        flux = area * coef * np.einsum("fd,fd->f", centroid - opp, normal)
        rows.append(np.arange(n_uf))
        cols.append(coarse.cell_faces[pc, i])
        vals.append(flux)
    P = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_uf, coarse.n_u),
    )
    P.data[np.abs(P.data) < 1e-14] = 0.0
    P.eliminate_zeros()
    return P


@dataclass
class SimplicialHierarchy:
    """Nested simplicial levels, [0] = finest (reference level convention)."""

    levels: List[SimplicialLevel]
    parent: List[np.ndarray]  # parent[l]: level l cells -> level l+1 cells
    P_rt: List[sp.csr_matrix]  # P_rt[l]: level l+1 -> level l

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    def p_l2(self, l: int) -> sp.csr_matrix:
        ne_f = self.levels[l].n_s
        return sp.csr_matrix(
            (np.ones(ne_f), (np.arange(ne_f), self.parent[l])),
            shape=(ne_f, self.levels[l + 1].n_s),
        )


def build_simplicial_hierarchy(gm: GeneralMesh, nlevels: int) -> SimplicialHierarchy:
    """`gm` is the COARSEST mesh (level nlevels-1); finer levels by uniform
    refinement (matching the reference's serial/parallel refinement of its
    unstructured meshes before agglomeration)."""
    meshes = [gm]
    parents_down: List[np.ndarray] = []
    for _ in range(nlevels - 1):
        fine, par = refine_simplicial(meshes[-1])
        meshes.append(fine)
        parents_down.append(par)
    meshes = meshes[::-1]
    parents = parents_down[::-1]
    levels = [build_simplicial_level(m) for m in meshes]
    P_rt = [
        rt_prolongator_simplicial(levels[l], levels[l + 1], parents[l])
        for l in range(nlevels - 1)
    ]
    return SimplicialHierarchy(levels=levels, parent=parents, P_rt=P_rt)
