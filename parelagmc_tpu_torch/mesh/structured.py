"""Tensor-product structured meshes (quads in 2D, hexes in 3D).

This is the host-side geometric backbone of the framework. The reference
builds its multilevel hierarchy by agglomerating unstructured MFEM meshes
(ParELAG AMGe); the golden test and SPE10 configurations, however, are all
tensor-product meshes refined uniformly (reference:
examples/example_helpers/Build3DMesh.hpp, src/MeshUtilities.hpp:20-41), for
which structured coarsening reproduces the exact coarse spaces. We therefore
make the structured mesh a first-class object with O(1) index math for
faces, incidence, prolongation and embedding - everything downstream
(assembly, hierarchy, device packing) is vectorized NumPy on top of it.

Conventions
-----------
* Cells are indexed lexicographically, x fastest:
  ``e = i + nx*(j + ny*k)``.
* Faces are grouped by normal axis (x-faces, then y-faces, then z-faces);
  within a group they are indexed lexicographically with the same x-fastest
  rule on their (nx+1, ny, nz)-style index grids.
* The RT0 dof on a face is the *flux in the +axis direction* through the
  face. The signed incidence of cell e and face f is +1 if the +axis normal
  points out of e (i.e. f is the "high" face of e along its axis), -1 if it
  points into e.
* Boundary attributes follow MFEM's generated-mesh convention
  (reference meshes are built with mfem::Mesh(nx,ny,nz,...)):
  3D: z=0 -> 1, y=0 -> 2, x=max -> 3, y=max -> 4, x=0 -> 5, z=max -> 6;
  2D: y=0 -> 1, x=max -> 2, y=max -> 3, x=0 -> 4.

The port's own copy of parelagmc_tpu/mesh/structured.py (host-side numpy, as
there): the port imports nothing of the JAX package. It keeps only
what the port calls (no face areas or axis labels, no attribute marking).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class StructuredMesh:
    """An axis-aligned tensor-product mesh.

    Parameters
    ----------
    axes : list of 1D float64 arrays, one per dimension; ``axes[a]`` holds the
        ``n_a + 1`` grid-line coordinates along axis ``a`` (strictly
        increasing, possibly non-uniform - SPE10 uses anisotropic uniform
        spacing, stretched grids are allowed).
    attributes : optional (ne,) int array of per-cell material attributes
        (default all 1). Used by embedded meshes (attribute 1 = original
        region) and by point-observation marking.
    """

    axes: List[np.ndarray]
    attributes: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.axes = [np.asarray(a, dtype=np.float64) for a in self.axes]
        for a in self.axes:
            if a.ndim != 1 or a.size < 2 or np.any(np.diff(a) <= 0):
                raise ValueError("axes must be strictly increasing 1D arrays")
        if self.attributes is None:
            self.attributes = np.ones(self.num_cells, dtype=np.int32)
        else:
            self.attributes = np.asarray(self.attributes, dtype=np.int32)
            if self.attributes.shape != (self.num_cells,):
                raise ValueError("attributes must have shape (num_cells,)")

    # -- basic sizes ------------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Number of cells per axis."""
        return tuple(a.size - 1 for a in self.axes)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def spacings(self) -> List[np.ndarray]:
        """Per-axis arrays of cell widths."""
        return [np.diff(a) for a in self.axes]

    # -- faces -------------------------------------------------------------
    def face_grid_shape(self, axis: int) -> Tuple[int, ...]:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    def num_faces_axis(self, axis: int) -> int:
        return int(np.prod(self.face_grid_shape(axis)))

    @property
    def face_offsets(self) -> np.ndarray:
        """Start index of each axis group in the global face numbering."""
        counts = [self.num_faces_axis(a) for a in range(self.dim)]
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    @property
    def num_faces(self) -> int:
        return int(self.face_offsets[-1])

    def _ravel(self, idx: Sequence[np.ndarray], shape: Tuple[int, ...]) -> np.ndarray:
        """Lexicographic (x fastest) ravel of per-axis index arrays."""
        out = np.zeros_like(np.asarray(idx[0], dtype=np.int64))
        stride = 1
        for a, s in enumerate(shape):
            out = out + np.asarray(idx[a], dtype=np.int64) * stride
            stride *= s
        return out

    def cell_index(self, *ijk: np.ndarray) -> np.ndarray:
        return self._ravel(ijk, self.shape)

    def face_index(self, axis: int, *ijk: np.ndarray) -> np.ndarray:
        return int(self.face_offsets[axis]) + self._ravel(
            ijk, self.face_grid_shape(axis)
        )

    def cell_multi_index(self) -> List[np.ndarray]:
        """Per-axis index arrays for all cells, each of shape (ne,)."""
        grids = np.meshgrid(
            *[np.arange(s, dtype=np.int64) for s in self.shape], indexing="ij"
        )
        # meshgrid('ij') is axis-0 slowest when raveled with C order; we need
        # x fastest, so ravel with Fortran order.
        return [g.ravel(order="F") for g in grids]

    # -- geometry -----------------------------------------------------------
    def cell_volumes(self) -> np.ndarray:
        widths = [np.diff(a) for a in self.axes]
        grids = np.meshgrid(*widths, indexing="ij")
        vol = grids[0].copy()
        for g in grids[1:]:
            vol = vol * g
        return vol.ravel(order="F")

    def cell_widths(self, axis: int) -> np.ndarray:
        """Per-cell width along `axis`, shape (ne,)."""
        idx = self.cell_multi_index()
        return np.diff(self.axes[axis])[idx[axis]]

    def cell_centers(self) -> np.ndarray:
        idx = self.cell_multi_index()
        mids = [0.5 * (a[1:] + a[:-1]) for a in self.axes]
        return np.stack([mids[a][idx[a]] for a in range(self.dim)], axis=1)

    # -- cell <-> face incidence -------------------------------------------
    def cell_faces(self) -> Tuple[np.ndarray, np.ndarray]:
        """Signed incidence: returns (faces, signs), each (ne, 2*dim).

        Column order: for axis a, the "low" face (sign -1) then the "high"
        face (sign +1). The sign is the orientation of the +axis dof normal
        relative to the outward normal of the cell.
        """
        idx = self.cell_multi_index()
        ne = self.num_cells
        faces = np.empty((ne, 2 * self.dim), dtype=np.int64)
        signs = np.empty((ne, 2 * self.dim), dtype=np.float64)
        for a in range(self.dim):
            lo = list(idx)
            hi = list(idx)
            hi = [x.copy() for x in hi]
            hi[a] = hi[a] + 1
            faces[:, 2 * a] = self.face_index(a, *lo)
            faces[:, 2 * a + 1] = self.face_index(a, *hi)
            signs[:, 2 * a] = -1.0
            signs[:, 2 * a + 1] = +1.0
        return faces, signs

    def boundary_faces(self) -> Tuple[np.ndarray, np.ndarray]:
        """Global indices and MFEM-style attributes of all boundary faces."""
        out_idx = []
        out_attr = []
        d = self.dim
        for a in range(d):
            shape = self.face_grid_shape(a)
            other = [np.arange(s, dtype=np.int64) for ax, s in enumerate(shape) if ax != a]
            grids = np.meshgrid(*other, indexing="ij") if other else []
            flat = [g.ravel(order="F") for g in grids]
            for side, pos in ((0, 0), (1, shape[a] - 1)):
                ijk: List[np.ndarray] = []
                it = iter(flat)
                for ax in range(d):
                    if ax == a:
                        ijk.append(np.full(flat[0].shape if flat else (1,), pos, dtype=np.int64))
                    else:
                        ijk.append(next(it))
                out_idx.append(self.face_index(a, *ijk))
                out_attr.append(
                    np.full(out_idx[-1].shape, _mfem_bdr_attr(d, a, side), dtype=np.int32)
                )
        return np.concatenate(out_idx), np.concatenate(out_attr)

    def boundary_attr_of_faces(self) -> np.ndarray:
        """(num_faces,) array: MFEM boundary attribute per face, 0 = interior."""
        attr = np.zeros(self.num_faces, dtype=np.int32)
        f, a = self.boundary_faces()
        attr[f] = a
        return attr

    # -- refinement ----------------------------------------------------------
    def face_axis(self) -> np.ndarray:
        """(num_faces,) array with the normal axis of every face."""
        out = np.empty(self.num_faces, dtype=np.int32)
        off = self.face_offsets
        for a in range(self.dim):
            out[off[a]: off[a + 1]] = a
        return out

    def refine(self) -> "StructuredMesh":
        """Uniform refinement: every cell split in 2^dim; grid lines get
        midpoints. Attributes are inherited by children."""
        new_axes = []
        for a in self.axes:
            mids = 0.5 * (a[1:] + a[:-1])
            merged = np.empty(a.size + mids.size, dtype=np.float64)
            merged[0::2] = a
            merged[1::2] = mids
            new_axes.append(merged)
        fine = StructuredMesh(new_axes)
        fine.attributes = self.attributes[fine.parent_cells(self)]
        return fine

    def parent_cells(self, coarse: "StructuredMesh") -> np.ndarray:
        """(ne_fine,) index of the coarse cell containing each fine cell,
        assuming `coarse` is this mesh derefined once (2x per axis)."""
        idx = self.cell_multi_index()
        cidx = [x // 2 for x in idx]
        return coarse.cell_index(*cidx)

def _mfem_bdr_attr(dim: int, axis: int, side: int) -> int:
    """MFEM generated-mesh boundary attributes.

    3D (mfem::Mesh::Make3D): bottom z=0 -> 1, front y=0 -> 2, right x=max -> 3,
    back y=max -> 4, left x=0 -> 5, top z=max -> 6.
    2D (Make2D): bottom y=0 -> 1, right x=max -> 2, top y=max -> 3, left x=0 -> 4.
    1D: x=0 -> 1, x=max -> 2.
    """
    if dim == 3:
        table = {(2, 0): 1, (1, 0): 2, (0, 1): 3, (1, 1): 4, (0, 0): 5, (2, 1): 6}
    elif dim == 2:
        table = {(1, 0): 1, (0, 1): 2, (1, 1): 3, (0, 0): 4}
    else:
        table = {(0, 0): 1, (0, 1): 2}
    return table[(axis, side)]
