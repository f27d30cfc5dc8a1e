"""MFEM mesh file reader (the port's copy of parelagmc_tpu/mesh/mfem_io.py,
numpy only; the port imports nothing of the JAX package).

Reads both formats the reference's bundled meshes use
(ParELAGMC meshes/*.mesh):

* "MFEM INLINE mesh v1.0" - generated tensor meshes (type/nx/sx keys);
  mapped directly onto StructuredMesh.
* "MFEM mesh v1.0" - explicit element/boundary/vertex lists, parsed into a
  GeneralMesh record. Axis-aligned tensor-product hex/quad meshes (e.g.
  cube_hex_embed.mesh, square_embed.mesh) are *detected* and converted to
  StructuredMesh with their per-cell attributes (the embedded-region
  markers the embedded samplers consume); genuinely unstructured meshes
  (tets/triangles/curved boundaries) are returned as GeneralMesh and flow
  into the simplicial FEM stack (fem/simplicial.py, unstructured.py).

The writer lives in utils/io_vtk.save_mesh_mfem.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

from parelagmc_tpu_torch.mesh.factories import make_box_mesh
from parelagmc_tpu_torch.mesh.structured import StructuredMesh

GEOM_NVERTS = {1: 2, 2: 3, 3: 4, 4: 4, 5: 8}  # segment/tri/quad/tet/hex


@dataclass
class GeneralMesh:
    dim: int
    vertices: np.ndarray  # (nv, dim)
    elements: List[np.ndarray]  # per element: vertex ids
    attributes: np.ndarray  # (ne,)
    geom_types: np.ndarray  # (ne,) MFEM geometry codes
    boundary: List[np.ndarray]
    boundary_attributes: np.ndarray

    @property
    def num_cells(self) -> int:
        return len(self.elements)

    def cell_centers(self) -> np.ndarray:
        conn = np.stack(self.elements)
        return self.vertices[conn].mean(axis=1)

    def cell_volumes(self) -> np.ndarray:
        import math

        conn = np.stack(self.elements)
        p = self.vertices[conn]
        if p.shape[1] != self.dim + 1:
            raise NotImplementedError("volumes implemented for simplices only")
        mats = p[:, 1:, :] - p[:, :1, :]
        return np.abs(np.linalg.det(mats)) / math.factorial(self.dim)


def _tokens(text: str):
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            yield from line.split()


def read_mfem_mesh(path: str) -> Union[StructuredMesh, GeneralMesh]:
    text = open(path).read()
    header = text.splitlines()[0].strip()
    if header.startswith("MFEM INLINE"):
        return _read_inline(text)
    if not header.startswith("MFEM mesh v1"):
        raise ValueError(f"unsupported mesh header: {header!r}")
    gm = _read_v10(text)
    sm = try_as_structured(gm)
    return sm if sm is not None else gm


def _read_inline(text: str) -> StructuredMesh:
    kv = dict(
        re.findall(r"^\s*(\w+)\s*=\s*([\w.+-]+)\s*$", text, flags=re.MULTILINE)
    )
    typ = kv["type"]
    if typ == "tri":
        # Structured grid split into 2 triangles per cell (MFEM Make2D).
        nx, ny = int(kv["nx"]), int(kv["ny"])
        sx, sy = float(kv.get("sx", 1.0)), float(kv.get("sy", 1.0))
        xs = np.linspace(0.0, sx, nx + 1)
        ys = np.linspace(0.0, sy, ny + 1)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)

        def vid(i, j):
            return i + (nx + 1) * j

        elements = []
        for j in range(ny):
            for i in range(nx):
                elements.append(np.array([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)]))
                elements.append(np.array([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)]))
        ne = len(elements)
        return GeneralMesh(
            dim=2,
            vertices=verts,
            elements=elements,
            attributes=np.ones(ne, dtype=np.int32),
            geom_types=np.full(ne, 2, dtype=np.int32),
            boundary=[],
            boundary_attributes=np.zeros(0, dtype=np.int32),
        )
    if typ == "tet":
        # Structured grid, each cube split into 6 tets around the main
        # diagonal (MFEM Make3D tet decomposition).
        nx, ny, nz = int(kv["nx"]), int(kv["ny"]), int(kv["nz"])
        sx = float(kv.get("sx", 1.0))
        sy = float(kv.get("sy", 1.0))
        sz = float(kv.get("sz", 1.0))
        xs, ys, zs = (
            np.linspace(0, sx, nx + 1),
            np.linspace(0, sy, ny + 1),
            np.linspace(0, sz, nz + 1),
        )
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        verts = np.stack(
            [X.ravel(order="F"), Y.ravel(order="F"), Z.ravel(order="F")], axis=1
        )

        def vid(i, j, k):
            return i + (nx + 1) * (j + (ny + 1) * k)

        tet_split = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
                     (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]
        elements = []
        for k in range(nz):
            for j in range(ny):
                for i in range(nx):
                    c = [
                        vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
                        vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
                        vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1),
                    ]
                    for t in tet_split:
                        elements.append(np.array([c[v] for v in t]))
        ne = len(elements)
        return GeneralMesh(
            dim=3,
            vertices=verts,
            elements=elements,
            attributes=np.ones(ne, dtype=np.int32),
            geom_types=np.full(ne, 4, dtype=np.int32),
            boundary=[],
            boundary_attributes=np.zeros(0, dtype=np.int32),
        )
    if typ not in ("quad", "hex"):
        raise ValueError(f"INLINE mesh type '{typ}' needs the unstructured path")
    if typ == "quad":
        n = (int(kv["nx"]), int(kv["ny"]))
        s = (float(kv.get("sx", 1.0)), float(kv.get("sy", 1.0)))
    else:
        n = (int(kv["nx"]), int(kv["ny"]), int(kv["nz"]))
        s = (
            float(kv.get("sx", 1.0)),
            float(kv.get("sy", 1.0)),
            float(kv.get("sz", 1.0)),
        )
    return make_box_mesh(n, lengths=s)


def _read_v10(text: str) -> GeneralMesh:
    it = _tokens(text)
    toks = list(it)
    pos = {}
    for key in ("dimension", "elements", "boundary", "vertices"):
        try:
            pos[key] = toks.index(key)
        except ValueError:
            pos[key] = None
    # Skip the leading "MFEM mesh v1.0" tokens by seeking named sections.
    i = pos["dimension"] + 1
    dim = int(toks[i])

    i = pos["elements"] + 1
    ne = int(toks[i]); i += 1
    elements, attrs, geoms = [], [], []
    for _ in range(ne):
        attr = int(toks[i]); geom = int(toks[i + 1])
        nv = GEOM_NVERTS[geom]
        elements.append(np.array([int(t) for t in toks[i + 2: i + 2 + nv]]))
        attrs.append(attr)
        geoms.append(geom)
        i += 2 + nv

    boundary, battrs = [], []
    if pos["boundary"] is not None:
        i = pos["boundary"] + 1
        nb = int(toks[i]); i += 1
        for _ in range(nb):
            attr = int(toks[i]); geom = int(toks[i + 1])
            nv = GEOM_NVERTS[geom]
            boundary.append(np.array([int(t) for t in toks[i + 2: i + 2 + nv]]))
            battrs.append(attr)
            i += 2 + nv

    i = pos["vertices"] + 1
    nv_total = int(toks[i]); vdim = int(toks[i + 1]); i += 2
    coords = np.array(
        [float(t) for t in toks[i: i + nv_total * vdim]], dtype=np.float64
    ).reshape(nv_total, vdim)

    return GeneralMesh(
        dim=dim,
        vertices=coords[:, :dim],
        elements=elements,
        attributes=np.asarray(attrs, dtype=np.int32),
        geom_types=np.asarray(geoms, dtype=np.int32),
        boundary=boundary,
        boundary_attributes=np.asarray(battrs, dtype=np.int32),
    )


def try_as_structured(gm: GeneralMesh, tol: float = 1e-10) -> Optional[StructuredMesh]:
    """Detect an axis-aligned tensor-product quad/hex mesh and convert it,
    carrying per-cell attributes (cells matched by center)."""
    d = gm.dim
    want_geom = 3 if d == 2 else 5
    if not np.all(gm.geom_types == want_geom):
        return None
    axes = []
    for a in range(d):
        vals = np.unique(np.round(gm.vertices[:, a] / tol) * tol)
        merged = [vals[0]]
        for v in vals[1:]:
            if v - merged[-1] > 10 * tol:
                merged.append(v)
        axes.append(np.asarray(merged))
    shape = tuple(len(ax) - 1 for ax in axes)
    if int(np.prod(shape)) != gm.num_cells:
        return None
    if int(np.prod([len(ax) for ax in axes])) != gm.vertices.shape[0]:
        return None
    mesh = StructuredMesh(axes)
    # Match cells by center; verify every cell is a full grid box.
    centers = np.stack(
        [gm.vertices[el].mean(axis=0) for el in gm.elements], axis=0
    )
    idx = []
    for a in range(d):
        j = np.searchsorted(axes[a], centers[:, a]) - 1
        if np.any(j < 0) or np.any(j >= shape[a]):
            return None
        mid = 0.5 * (axes[a][j] + axes[a][j + 1])
        if not np.allclose(mid, centers[:, a], atol=1e3 * tol):
            return None
        idx.append(j.astype(np.int64))
    cell = mesh.cell_index(*idx)
    if np.unique(cell).size != gm.num_cells:
        return None
    attrs = np.ones(gm.num_cells, dtype=np.int32)
    attrs[cell] = gm.attributes
    mesh.attributes = attrs
    return mesh
