"""Lowest-order mixed FEM (RT0/P0) on unstructured simplicial meshes.

The port's copy of parelagmc_tpu/fem/simplicial.py (numpy/scipy, as there):
face numbering, signs and the mass ELL are the original's, array for array.

Extends the framework beyond tensor grids to the reference's triangular and
tetrahedral meshes (square.mesh, cube_tet.mesh, circle.mesh, ... -
ParELAGMC meshes): host-side NumPy assembly of the same operator
bundle the structured path produces, consumed by the *generic* device
machinery (coefficient-ELL gathers, batched PCG/MINRES). This module
provides the single-level spaces; multilevel hierarchies on these meshes
come from uniform refinement (fem/simplicial_hierarchy.py) or algebraic
agglomeration with minimum-energy coarse bases (fem/agglomeration.py, the
analog of the reference's ParELAG AMGe coarsening).

Discretization facts used:
* Faces (edges in 2D) are identified by sorted vertex tuples; the global
  dof is the flux through the face along its fixed global normal (oriented
  outward from the first adjacent cell).
* RT0 basis on a simplex: phi_i = c_i (x - p_i), p_i the vertex opposite
  face i; c_i is fixed by unit flux through face i. int_K div phi_i = +-1
  exactly, so the (p, div u) incidence B has entries +-1 like the
  structured path.
* Element mass matrices are integrated with a degree-2 simplex quadrature
  (exact: the integrand is quadratic).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from parelagmc_tpu_torch.fem.assembly import pack_ell
from parelagmc_tpu_torch.mesh.mfem_io import GeneralMesh


def _simplex_quadrature(d: int):
    """Degree-2 quadrature on the reference simplex: (barycentric points,
    weights summing to 1)."""
    if d == 2:
        pts = np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
                        [1 / 6, 1 / 6, 2 / 3]])
        w = np.full(3, 1.0 / 3.0)
    else:
        a = (5.0 - np.sqrt(5.0)) / 20.0
        b = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
        pts = np.array(
            [[b, a, a, a], [a, b, a, a], [a, a, b, a], [a, a, a, b]]
        )
        w = np.full(4, 0.25)
    return pts, w


@dataclass
class SimplicialLevel:
    """Operator bundle for one unstructured simplicial mesh (single level).

    Mirrors fem.assembly.MixedLevel's fields consumed by the device layer.
    """

    mesh: GeneralMesh
    n_u: int
    n_s: int
    m_cols: np.ndarray  # (n_u, K) coefficient-ELL of the RT0 mass
    m_vals: np.ndarray
    m_cells: np.ndarray
    cell_faces: np.ndarray  # (n_s, d+1)
    cell_signs: np.ndarray
    face_cells: np.ndarray  # (n_u, 2)
    face_signs: np.ndarray
    W: np.ndarray
    w_sqrt: np.ndarray
    bdr_attr: np.ndarray  # (n_u,) boundary attribute, 0 = interior
    outward_sign: np.ndarray  # (n_u,) +-1 on boundary faces, 0 interior

    @property
    def dim(self) -> int:
        return self.mesh.dim

    def mass_csr(self, coeff: Optional[np.ndarray] = None) -> sp.csr_matrix:
        c = np.ones(self.n_s) if coeff is None else np.asarray(coeff, np.float64)
        rows = np.repeat(np.arange(self.n_u), self.m_cols.shape[1])
        vals = (self.m_vals * c[self.m_cells]).ravel()
        return sp.csr_matrix(
            (vals, (rows, self.m_cols.ravel())), shape=(self.n_u, self.n_u)
        )

    def b_csr(self) -> sp.csr_matrix:
        rows = np.repeat(np.arange(self.n_s), self.cell_faces.shape[1])
        return sp.csr_matrix(
            (self.cell_signs.ravel(), (rows, self.cell_faces.ravel())),
            shape=(self.n_s, self.n_u),
        )

    def ess_faces(self, ess_attr: np.ndarray) -> np.ndarray:
        ess_attr = np.asarray(ess_attr, dtype=np.int64)
        mask = np.zeros(self.n_u, dtype=bool)
        on = self.bdr_attr > 0
        idx = np.minimum(self.bdr_attr[on] - 1, len(ess_attr) - 1)
        mask[on] = ess_attr[idx] == 1
        return mask


def build_simplicial_level(gm: GeneralMesh) -> SimplicialLevel:
    d = gm.dim
    want = 4 if d == 3 else 2  # tet / tri geometry codes
    if not np.all(gm.geom_types == want):
        raise ValueError("mesh is not purely simplicial")
    conn = np.stack(gm.elements)  # (ne, d+1)
    ne = conn.shape[0]
    verts = gm.vertices

    # -- face identification --------------------------------------------------
    # Local face i = all vertices except local vertex i (opposite-vertex
    # convention).
    nloc = d + 1
    local_faces = [
        [j for j in range(nloc) if j != i] for i in range(nloc)
    ]
    face_vsets = np.stack(
        [np.sort(conn[:, lf], axis=1) for lf in local_faces], axis=1
    )  # (ne, d+1, d)
    flat = face_vsets.reshape(ne * nloc, d)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    n_u = uniq.shape[0]
    cell_faces = inv.reshape(ne, nloc)

    # face -> adjacent cells (owner first).
    face_cells = np.full((n_u, 2), -1, dtype=np.int64)
    order = np.argsort(cell_faces.ravel(), kind="stable")
    f_sorted = cell_faces.ravel()[order]
    e_sorted = np.repeat(np.arange(ne), nloc)[order]
    starts = np.searchsorted(f_sorted, np.arange(n_u))
    counts = np.bincount(f_sorted, minlength=n_u)
    face_cells[:, 0] = e_sorted[starts]
    two = counts == 2
    face_cells[two, 1] = e_sorted[starts[two] + 1]

    # -- geometry --------------------------------------------------------------
    import math as _math

    p = verts[conn]  # (ne, d+1, d)
    mats = p[:, 1:, :] - p[:, :1, :]  # (ne, d, d)
    vol = np.abs(np.linalg.det(mats)) / _math.factorial(d)

    # Signs: the dof normal is the outward normal of the OWNER cell's face;
    # the sign of face i seen from cell e is +1 iff e is the owner.
    cell_signs = np.where(
        face_cells[cell_faces, 0] == np.arange(ne)[:, None], 1.0, -1.0
    )
    face_signs = np.zeros((n_u, 2))
    face_signs[:, 0] = 1.0
    face_signs[two, 1] = -1.0

    # -- element mass matrices (quadrature) -------------------------------------
    bary, wq = _simplex_quadrature(d)
    xq = np.einsum("qi,eid->eqd", bary, p)  # (ne, nq, d)
    # Basis phi_i = c_i (x - p_i) with c_i = sign_i / (d * |K|): the flux
    # through face i along the owner-outward global normal is exactly 1
    # ((x - p_i).n is the constant vertex-to-plane distance h_i on the face,
    # and h_i |f_i| = d |K|), and int_K div phi_i = sign_i - so B has +-1
    # entries like the structured path.
    Me = np.zeros((ne, nloc, nloc))
    coef = np.zeros((ne, nloc))
    for i in range(nloc):
        coef[:, i] = cell_signs[:, i] / (d * vol)
    phis = []
    for i in range(nloc):
        phi = coef[:, i, None, None] * (xq - p[:, i, None, :])  # (ne, nq, d)
        phis.append(phi)
    for i in range(nloc):
        for j in range(i, nloc):
            val = vol * np.einsum("q,eqd,eqd->e", wq, phis[i], phis[j])
            Me[:, i, j] = val
            Me[:, j, i] = val

    rows = np.repeat(cell_faces[:, :, None], nloc, axis=2).reshape(-1)
    cols = np.repeat(cell_faces[:, None, :], nloc, axis=1).reshape(-1)
    vals = Me.reshape(-1)
    cells = np.repeat(np.arange(ne), nloc * nloc)
    m_cols, m_vals, m_cells = pack_ell(rows, cols, vals, n_u, cells=cells)

    # -- boundary attributes ------------------------------------------------------
    bdr_attr = np.zeros(n_u, dtype=np.int32)
    if gm.boundary:
        bkeys = np.sort(np.stack(gm.boundary), axis=1)
        # Map boundary faces to global ids via the unique table.
        pos = _rows_lookup(uniq, bkeys)
        ok = pos >= 0
        bdr_attr[pos[ok]] = gm.boundary_attributes[ok]
    # Faces with one adjacent cell are boundary even if unlabeled.
    lonely = ~two
    bdr_attr[lonely & (bdr_attr == 0)] = 1

    outward = np.zeros(n_u)
    outward[lonely] = 1.0  # dof normal is owner-outward by construction

    fc = face_cells.copy()
    fc[fc < 0] = 0
    return SimplicialLevel(
        mesh=gm,
        n_u=n_u,
        n_s=ne,
        m_cols=m_cols,
        m_vals=m_vals,
        m_cells=m_cells,
        cell_faces=cell_faces.astype(np.int64),
        cell_signs=cell_signs,
        face_cells=fc,
        face_signs=face_signs,
        W=vol,
        w_sqrt=np.sqrt(vol),
        bdr_attr=bdr_attr,
        outward_sign=outward,
    )


def _rows_lookup(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in the lexicographically-sorted-unique table
    (np.unique(axis=0) order), -1 if absent. Rows are encoded as integers
    with the first column most significant, preserving the lex order."""
    base = int(max(table.max(), queries.max() if queries.size else 0)) + 2
    d = table.shape[1]
    weights = np.array([base ** (d - 1 - k) for k in range(d)], dtype=np.int64)

    def key(a):
        return (a.astype(np.int64) * weights[None, :]).sum(axis=1)

    tk = key(table)
    qk = key(queries)
    idx = np.searchsorted(tk, qk)
    idx = np.clip(idx, 0, tk.size - 1)
    return np.where(tk[idx] == qk, idx, -1)
