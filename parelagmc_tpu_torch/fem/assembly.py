"""Lowest-order mixed FEM (RT0 velocity / P0 pressure) on structured meshes.

Host-side (NumPy) assembly of everything the device kernels need, as static
index/value arrays:

* The RT0 mass matrix in *coefficient-ELL* form: per velocity-dof row f and
  slot k, the triple (col, mval, cell) such that

      M(c)[f, col[f,k]] = sum_k  c[cell[f,k]] * mval[f,k]

  for a piecewise-constant coefficient c. On axis-aligned tensor-product
  cells the RT0 basis functions of different axes are L2-orthogonal, so each
  row has at most 4 nonzero slots (diagonal from each of <=2 adjacent cells
  + one opposite-face coupling per adjacent cell). This is the device-side
  analog of the reference's per-sample ComputeMassOperator(uform, k)
  (ParELAGMC src/DarcySolver.cpp:479): instead of re-assembling a CSR
  matrix per sample, the sample coefficient is gathered into the static
  pattern inside jit.

* The signed incidence B[cell, face] = +/-1 (the (div u, q) form: for RT0/P0,
  int_K div u = sum of signed face fluxes). The reference's B = W * D
  (src/PDESampler.cpp:245) equals this incidence.

* W = diag(cell volumes), the (diagonal) P0 mass matrix, and w_sqrt.

Element matrices: on cell e with widths (h_a) and volume V, for each axis a
the two basis functions (flux dofs oriented along +a) have
    int phi_i . phi_j = h_a^2/(3V) (i == j),  h_a^2/(6V) (i != j),
and cross-axis products vanish. (Standard RT0-on-box integrals; validated in
tests against dense quadrature.)

The port's own copy of parelagmc_tpu/fem/assembly.py (host-side numpy and scipy, as
there): the port imports nothing of the JAX package. It keeps only
what the port calls: `pack_ell` (the simplicial and agglomerated levels'
mass ELL) and the mixed level, without the SPDE operator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from parelagmc_tpu_torch.mesh.structured import StructuredMesh


def pack_ell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    cells: Optional[np.ndarray] = None,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, ...]:
    """Pack COO triplets (+ optional per-entry cell index) into padded ELL.

    Duplicate (row, col) entries are kept as separate slots (the device
    gather-sum adds them), so no merging pass is needed. Padding slots have
    col = 0, val = 0 (and cell = 0).

    Returns (ell_cols, ell_vals[, ell_cells]) with shape (n_rows, width).
    """
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals, dtype=np.float64).ravel()
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    if cells is not None:
        cells = np.asarray(cells, dtype=np.int64).ravel()[order]
    counts = np.bincount(rows, minlength=n_rows)
    w = int(counts.max()) if counts.size else 0
    if width is not None:
        if w > width:
            raise ValueError(f"ELL width {width} < max row nnz {w}")
        w = width
    # Slot index of each entry within its row.
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(rows.size) - starts[rows]
    ell_cols = np.zeros((n_rows, w), dtype=np.int32)
    ell_vals = np.zeros((n_rows, w), dtype=np.float64)
    ell_cols[rows, slot] = cols
    ell_vals[rows, slot] = vals
    out = [ell_cols, ell_vals]
    if cells is not None:
        ell_cells = np.zeros((n_rows, w), dtype=np.int32)
        ell_cells[rows, slot] = cells
        out.append(ell_cells)
    return tuple(out)


@dataclass
class MixedLevel:
    """All host-side operators of one level of the RT0/P0 mixed hierarchy."""

    mesh: StructuredMesh
    n_u: int  # velocity (face) dofs
    n_s: int  # pressure/field (cell) dofs

    # Coefficient-ELL of the RT0 mass matrix (unconstrained).
    m_cols: np.ndarray  # (n_u, Km) int32
    m_vals: np.ndarray  # (n_u, Km) float64
    m_cells: np.ndarray  # (n_u, Km) int32

    # Signed incidence (B and B^T as gathers).
    cell_faces: np.ndarray  # (n_s, 2*dim) int64 - faces of each cell
    cell_signs: np.ndarray  # (n_s, 2*dim) float64 - outward sign of +axis dof
    face_cells: np.ndarray  # (n_u, 2) int32 - cells adjacent to each face
    face_signs: np.ndarray  # (n_u, 2) float64 - sign of face in that cell (0 pad)

    W: np.ndarray  # (n_s,) cell volumes = diag of P0 mass
    w_sqrt: np.ndarray  # (n_s,)
    bdr_attr: np.ndarray  # (n_u,) boundary attribute per face (0 = interior)

    @property
    def dim(self) -> int:
        return self.mesh.dim

    # -- reference (scipy) operators for oracles and host solves -----------
    def mass_csr(self, coeff: Optional[np.ndarray] = None) -> sp.csr_matrix:
        c = np.ones(self.n_s) if coeff is None else np.asarray(coeff, dtype=np.float64)
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
        """Bool mask of essential velocity dofs given a per-boundary-attribute
        0/1 vector (MFEM convention: ess_attr[attr-1] == 1)."""
        ess_attr = np.asarray(ess_attr, dtype=np.int32)
        mask = np.zeros(self.n_u, dtype=bool)
        on_bdr = self.bdr_attr > 0
        mask[on_bdr] = ess_attr[self.bdr_attr[on_bdr] - 1] == 1
        return mask

def build_mixed_level(mesh: StructuredMesh) -> MixedLevel:
    """Assemble the level operators with pure index arithmetic - no sorting
    or scatters, so SPE10-scale meshes (3.4M faces) build in seconds."""
    d = mesh.dim
    n_s = mesh.num_cells
    n_u = mesh.num_faces
    vol = mesh.cell_volumes()

    cell_faces, cell_signs = mesh.cell_faces()

    # Per-axis direct construction. Array layout is the reversed grid
    # (z, y, x); mesh axis a is array dim d-1-a; C-order ravel is x-fastest,
    # matching the global face/cell numbering.
    rshape = mesh.shape[::-1]
    cell_ids = np.arange(n_s, dtype=np.int64).reshape(rshape)
    vol_g = vol.reshape(rshape)

    face_cells = np.zeros((n_u, 2), dtype=np.int64)
    face_signs = np.zeros((n_u, 2), dtype=np.float64)
    m_cols = np.zeros((n_u, 4), dtype=np.int32)
    m_vals = np.zeros((n_u, 4), dtype=np.float64)
    m_cells = np.zeros((n_u, 4), dtype=np.int32)
    for a in range(d):
        dim_a = d - 1 - a
        h = np.diff(mesh.axes[a])
        hshape = [1] * d
        hshape[dim_a] = h.size
        h_g = h.reshape(hshape)
        m3 = np.broadcast_to(h_g * h_g, rshape) / (3.0 * vol_g)
        m6 = np.broadcast_to(h_g * h_g, rshape) / (6.0 * vol_g)

        def pad(arr, side):
            """Faces along axis a: value from the lo/hi adjacent cell, zero
            padding at the boundary."""
            pw = [(0, 0)] * d
            pw[dim_a] = (1, 0) if side == "lo" else (0, 1)
            return np.pad(arr, pw)

        def flat(x):
            return x.reshape(-1)

        # Global face index grid for this axis, in array layout.
        fshape_r = list(rshape)
        fshape_r[dim_a] += 1
        nfa = int(np.prod(fshape_r))
        off = int(mesh.face_offsets[a])
        rows = slice(off, off + nfa)
        F = off + np.arange(nfa, dtype=np.int64).reshape(fshape_r)
        take_lo = [slice(None)] * d
        take_lo[dim_a] = slice(0, fshape_r[dim_a] - 1)
        take_hi = [slice(None)] * d
        take_hi[dim_a] = slice(1, fshape_r[dim_a])

        # Adjacent cells (lo = below the face along a, hi = above) and the
        # sign of the +axis dof seen from each (hi face of lo cell: +1).
        has_lo = np.zeros(fshape_r, dtype=bool)
        has_lo[tuple(take_hi)] = True
        has_hi = np.zeros(fshape_r, dtype=bool)
        has_hi[tuple(take_lo)] = True
        face_cells[rows, 0] = flat(pad(cell_ids, "lo"))
        face_cells[rows, 1] = flat(pad(cell_ids, "hi"))
        face_signs[rows, 0] = flat(has_lo) * 1.0
        face_signs[rows, 1] = flat(has_hi) * -1.0

        m_cols[rows, 0] = F.reshape(-1)
        m_cols[rows, 1] = F.reshape(-1)
        m_cols[rows, 2] = flat(pad(F[tuple(take_lo)], "lo"))  # face i-1
        m_cols[rows, 3] = flat(pad(F[tuple(take_hi)], "hi"))  # face i+1
        m_vals[rows, 0] = flat(pad(m3, "lo"))
        m_vals[rows, 1] = flat(pad(m3, "hi"))
        m_vals[rows, 2] = flat(pad(m6, "lo"))
        m_vals[rows, 3] = flat(pad(m6, "hi"))
        m_cells[rows, 0] = face_cells[rows, 0]
        m_cells[rows, 1] = face_cells[rows, 1]
        m_cells[rows, 2] = face_cells[rows, 0]
        m_cells[rows, 3] = face_cells[rows, 1]
    # Zero-padding slots: cols/cells already hold index 0 only where the
    # value is 0 (boundary pads), except the diag/off slots whose padded
    # value is 0 - force their cols to 0 for cleanliness.
    m_cols *= m_vals != 0.0
    m_cells *= m_vals != 0.0
    face_cells *= face_signs != 0.0

    return MixedLevel(
        mesh=mesh,
        n_u=n_u,
        n_s=n_s,
        m_cols=m_cols,
        m_vals=m_vals,
        m_cells=m_cells,
        cell_faces=cell_faces,
        cell_signs=cell_signs,
        face_cells=face_cells,
        face_signs=face_signs,
        W=vol,
        w_sqrt=np.sqrt(vol),
        bdr_attr=mesh.boundary_attr_of_faces(),
    )
