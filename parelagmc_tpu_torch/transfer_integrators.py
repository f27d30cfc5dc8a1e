"""Higher-order and vector mortar integrators over non-matching meshes.

The reference couples not only piecewise constants but arbitrary-order
scalar L2 fields and vector (RT) fields across non-matching meshes
(ParELAGMC src/transfer/MortarIntegrator.hpp:19-111:
L2MortarIntegrator, VectorL2MortarIntegrator), evaluating element-pair mass
integrals on a composite quadrature of the clipped intersection. Here the
native clipper emits the intersection polytopes' MOMENTS up to degree two
(native/geometry.cc mortar_moments_couple); since every basis factor used
by this framework is affine (P1 hat functions; RT0 phi = c (x - p)), any
pair integral reduces exactly to

    int_{T1 cap T2} (a1 + b1.x)(a2 + b2.x)
        = a1 a2 V + a1 b2.m1 + a2 b1.m1 + b1^T M2 b2,

with V = int 1, m1 = int x, M2 = int x x^T - closed-form, no quadrature
error. Both assemblers below are oracle-tested against classical mass
matrices on identical meshes and against exact reproduction of linear /
RT0 fields across non-matching meshes (tests/test_transfer_integrators.py).

All of this is setup-time host work producing static coupling operators
(SURVEY.md 2.3/5.8: no runtime dynamic communication).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from parelagmc_tpu_torch.mesh.mfem_io import GeneralMesh
from parelagmc_tpu_torch.native import mortar_moments


def _m2_full(m2: np.ndarray, dim: int) -> np.ndarray:
    """(n, dim, dim) symmetric second-moment tensors from the packed rows."""
    n = m2.shape[0]
    M = np.zeros((n, dim, dim))
    if dim == 3:
        M[:, 0, 0], M[:, 1, 1], M[:, 2, 2] = m2[:, 0], m2[:, 1], m2[:, 2]
        M[:, 0, 1] = M[:, 1, 0] = m2[:, 3]
        M[:, 0, 2] = M[:, 2, 0] = m2[:, 4]
        M[:, 1, 2] = M[:, 2, 1] = m2[:, 5]
    else:
        M[:, 0, 0], M[:, 1, 1] = m2[:, 0], m2[:, 1]
        M[:, 0, 1] = M[:, 1, 0] = m2[:, 2]
    return M


def _p1_affine_basis(gm: GeneralMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Per element, the affine coefficients of the d+1 hat functions:
    lambda_k(x) = alpha[e, k] + beta[e, k] . x (barycentric coordinates)."""
    conn = np.stack(gm.elements)
    d = gm.dim
    p = gm.vertices[conn]  # (ne, d+1, d)
    ne = conn.shape[0]
    # Solve [1 x^T] c = e_k per element: coefficients in the rows of the
    # inverse of the (d+1)x(d+1) node matrix.
    A = np.concatenate([np.ones((ne, d + 1, 1)), p], axis=2)  # (ne, d+1, d+1)
    Ainv = np.linalg.inv(A)  # column k = [alpha_k; beta_k]
    alpha = Ainv[:, 0, :]  # (ne, d+1)
    beta = Ainv[:, 1:, :].transpose(0, 2, 1)  # (ne, d+1, d)
    return alpha, beta


def mortar_p1_couple(gm1: GeneralMesh, gm2: GeneralMesh, tol: float = 1e-12):
    """Scalar P1-P1 mortar coupling B[vertex_i, vertex_j] =
    int phi_i psi_j over the mesh intersection (the reference's
    higher-order L2MortarIntegrator at the order this framework uses).
    Exact: both factors are affine per intersection polytope."""
    i, j, vol, m1, m2 = mortar_moments(gm1, gm2, tol)
    d = gm1.dim
    M2 = _m2_full(m2, d)
    a1, b1 = _p1_affine_basis(gm1)
    a2, b2 = _p1_affine_basis(gm2)
    conn1 = np.stack(gm1.elements)
    conn2 = np.stack(gm2.elements)
    nloc = d + 1
    rows, cols, vals = [], [], []
    for k in range(nloc):
        for l in range(nloc):
            ak, bk = a1[i, k], b1[i, k]  # (np,), (np, d)
            al, bl = a2[j, l], b2[j, l]
            val = (
                ak * al * vol
                + ak * np.einsum("pd,pd->p", bl, m1)
                + al * np.einsum("pd,pd->p", bk, m1)
                + np.einsum("pd,pde,pe->p", bk, M2, bl)
            )
            rows.append(conn1[i, k])
            cols.append(conn2[j, l])
            vals.append(val)
    n1 = gm1.vertices.shape[0]
    n2 = gm2.vertices.shape[0]
    B = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n1, n2),
    )
    B.sum_duplicates()
    return B


def mortar_p1_p0_couple(gm1: GeneralMesh, gm2: GeneralMesh, tol: float = 1e-12):
    """Mixed P1-P0 mortar coupling B[vertex_i, cell_j] = int_{supp phi_i
    cap C_j} phi_i over the mesh intersection: the reference's
    L2MortarIntegrator between a linear master space and the piecewise
    constant sampler field (MortarIntegrator.hpp:19-75 handles arbitrary
    order pairs; this is the (1, 0) instance). Exact: the only factor is
    affine per intersection polytope, so each entry is a_k V + b_k . m1.

    Returns (B, lump) with lump[i] = int phi_i over gm1 (the exact lumped
    P1 mass diagonal): B @ 1 == lump iff gm2 covers gm1 - the "no
    intersection, no transfer" coverage check for this pair of spaces."""
    i, j, vol, m1, _ = mortar_moments(gm1, gm2, tol)
    d = gm1.dim
    a1, b1 = _p1_affine_basis(gm1)
    conn1 = np.stack(gm1.elements)
    nloc = d + 1
    rows, cols, vals = [], [], []
    for k in range(nloc):
        ak, bk = a1[i, k], b1[i, k]
        rows.append(conn1[i, k])
        cols.append(j)
        vals.append(ak * vol + np.einsum("pd,pd->p", bk, m1))
    n1 = gm1.vertices.shape[0]
    n2 = len(gm2.elements)
    B = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n1, n2),
    )
    B.sum_duplicates()
    # Exact integral of each hat: each element contributes |K|/(d+1) to
    # every one of its vertices.
    p = gm1.vertices[conn1]
    volk = np.abs(np.linalg.det(p[:, 1:] - p[:, :1])) / math.factorial(d)
    lump = np.zeros(n1)
    np.add.at(lump, conn1, (volk / nloc)[:, None])
    return B, lump


def rt0_interpolate_constant(lvl, vec: np.ndarray) -> np.ndarray:
    """Exact RT0 interpolant of the constant vector field `vec`: dof i is
    the flux of `vec` through face i along the face's global orientation
    (outward from its owner element, `face_cells[:, 0]`). Demo/validation
    helper for the velocity mortar transfer - constants are in RT0 on any
    simplicial mesh, so a mortar L2 projection must reproduce them exactly
    (the same exactness class the reference's VectorL2MortarIntegrator
    tests rely on, MortarIntegrator.hpp:77-111)."""
    gm = lvl.mesh
    d = gm.dim
    conn = np.stack(gm.elements)
    nloc = d + 1
    local_faces = [[j for j in range(nloc) if j != i] for i in range(nloc)]
    dofs = np.zeros(lvl.n_u)
    owner = lvl.face_cells[:, 0]
    vec = np.asarray(vec, dtype=np.float64)[:d]
    for i, lf in enumerate(local_faces):
        fids = lvl.cell_faces[:, i]
        is_owner = owner[fids] == np.arange(conn.shape[0])
        q = gm.vertices[conn[:, lf]]  # (ne, d, d) face vertices
        if d == 3:
            nvec = 0.5 * np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
        else:
            e = q[:, 1] - q[:, 0]
            nvec = np.stack([e[:, 1], -e[:, 0]], axis=1)  # length-scaled
        cen = q.mean(axis=1)
        opp = gm.vertices[conn[:, i]]
        out = np.sign(np.einsum("ed,ed->e", cen - opp, nvec))
        flux = (nvec @ vec) * out
        dofs[fids[is_owner]] = flux[is_owner]
    return dofs


def mortar_rt0_couple(lvl1, lvl2, tol: float = 1e-12):
    """Vector RT0-RT0 mortar coupling B[face_i, face_j] =
    int phi_i . psi_j over the mesh intersection - the reference's
    VectorL2MortarIntegrator (MortarIntegrator.hpp:77-111) for
    lowest-order H(div) fields on simplicial meshes.

    RT0 basis on a simplex: phi_k = c_k (x - p_k) with c_k the level's
    sign/(d |K|) coefficient, so each pair integral is
    c1 c2 (tr(M2) - p1.m1 - p2.m1 + p1.p2 V). `lvl1`/`lvl2` are
    fem.simplicial.SimplicialLevel bundles."""
    gm1, gm2 = lvl1.mesh, lvl2.mesh
    d = gm1.dim
    i, j, vol, m1, m2 = mortar_moments(gm1, gm2, tol)
    trM2 = m2[:, :d].sum(axis=1)  # xx + yy (+ zz)
    conn1 = np.stack(gm1.elements)
    conn2 = np.stack(gm2.elements)
    p1v = gm1.vertices[conn1]  # (ne1, d+1, d)
    p2v = gm2.vertices[conn2]
    vol1 = np.abs(np.linalg.det(p1v[:, 1:] - p1v[:, :1])) / math.factorial(d)
    vol2 = np.abs(np.linalg.det(p2v[:, 1:] - p2v[:, :1])) / math.factorial(d)
    nloc = d + 1
    rows, cols, vals = [], [], []
    for k in range(nloc):
        ck = lvl1.cell_signs[i, k] / (d * vol1[i])
        pk = p1v[i, k]  # opposite vertex of face k
        for l in range(nloc):
            cl = lvl2.cell_signs[j, l] / (d * vol2[j])
            pl = p2v[j, l]
            val = ck * cl * (
                trM2
                - np.einsum("pd,pd->p", pk + pl, m1)
                + np.einsum("pd,pd->p", pk, pl) * vol
            )
            rows.append(lvl1.cell_faces[i, k])
            cols.append(lvl2.cell_faces[j, l])
            vals.append(val)
    B = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(lvl1.n_u, lvl2.n_u),
    )
    B.sum_duplicates()
    return B
