"""Field and mesh output: legacy VTK and MFEM/GLVis formats.

The port's copy of parelagmc_tpu/utils/io_vtk.py (numpy host code), whose
files it writes byte for byte: cell fields on tensor-product meshes as VTK
rectilinear grids (ParaView/VisIt), meshes and piecewise-constant fields in
MFEM's native format (GLVis) - the reference's SaveMeshGLVis /
SaveFieldGLVis / PrintVTK (src/PDESampler.cpp:637-755). A field may be a
numpy array or a torch tensor on any device (`_host` copies it to the host).
"""

from __future__ import annotations

import numpy as np
import torch

from parelagmc_tpu_torch.mesh.structured import StructuredMesh


def _host(field) -> np.ndarray:
    """numpy view of a field given as a numpy array or a torch tensor."""
    if isinstance(field, torch.Tensor):
        return field.detach().cpu().numpy()
    return np.asarray(field)


def save_vtk_cell_field(
    mesh: StructuredMesh, field: np.ndarray, path: str, name: str = "value"
) -> None:
    """Write a piecewise-constant cell field as a legacy-VTK rectilinear grid."""
    field = _host(field).ravel()
    assert field.size == mesh.num_cells
    d = mesh.dim
    axes = [mesh.axes[a] for a in range(d)] + [np.zeros(1)] * (3 - d)
    dims = [a.size for a in axes]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nparelagmc_tpu field\nASCII\n")
        f.write("DATASET RECTILINEAR_GRID\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        for label, a in zip(("X", "Y", "Z"), axes):
            f.write(f"{label}_COORDINATES {a.size} double\n")
            f.write(" ".join(f"{x:.10g}" for x in a) + "\n")
        f.write(f"CELL_DATA {mesh.num_cells}\n")
        f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        # VTK cell order is x fastest, then y, then z - our native order.
        f.write("\n".join(f"{v:.10g}" for v in field) + "\n")


def save_mesh_mfem(mesh: StructuredMesh, path: str) -> None:
    """Write the mesh in MFEM v1.0 format (quads in 2D, hexes in 3D) for
    GLVis. Vertex/element orderings follow MFEM's generated-mesh convention."""
    d = mesh.dim
    shape = mesh.shape
    # Vertices on the tensor grid, x fastest.
    grids = np.meshgrid(*mesh.axes, indexing="ij")
    pts = np.stack([g.ravel(order="F") for g in grids], axis=1)
    nvshape = tuple(s + 1 for s in shape)

    def vid(*ijk):
        out = 0
        stride = 1
        for a, s in enumerate(nvshape):
            out = out + ijk[a] * stride
            stride *= s
        return out

    idx = mesh.cell_multi_index()
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n%d\n\n" % d)
        f.write("elements\n%d\n" % mesh.num_cells)
        if d == 3:
            i, j, k = idx
            corners = np.stack(
                [
                    vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
                    vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1),
                ],
                axis=1,
            )
            geom = 5  # hexahedron
        elif d == 2:
            i, j = idx
            corners = np.stack(
                [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)], axis=1
            )
            geom = 3  # quadrilateral
        else:
            raise ValueError("1D MFEM output not supported")
        for e in range(mesh.num_cells):
            f.write(
                f"{mesh.attributes[e]} {geom} " + " ".join(map(str, corners[e])) + "\n"
            )
        f.write("\nboundary\n0\n\n")
        f.write("vertices\n%d\n%d\n" % (pts.shape[0], d))
        for p in pts:
            f.write(" ".join(f"{x:.10g}" for x in p) + "\n")


def cell_to_vertex_average(mesh: StructuredMesh, field: np.ndarray) -> np.ndarray:
    """Volume-weighted average of a cell field onto mesh vertices - the
    smooth-rendering analog of the reference's H1-projected savers
    (SaveFieldGLVis_H1, src/PDESampler.cpp:690-755)."""
    field = _host(field).ravel()
    d = mesh.dim
    nvshape = tuple(s + 1 for s in mesh.shape)
    acc = np.zeros(nvshape[::-1])
    wacc = np.zeros(nvshape[::-1])
    vals = field.reshape(mesh.shape[::-1])
    w = mesh.cell_volumes().reshape(mesh.shape[::-1])
    # Scatter each cell value to its 2^d corner vertices.
    for corner in range(2 ** d):
        slices = []
        for a in range(d):  # array dims are reversed (z, y, x)
            off = (corner >> a) & 1
            n = mesh.shape[d - 1 - a]
            slices.append(slice(off, n + off))
        acc[tuple(slices)] += w * vals
        wacc[tuple(slices)] += w
    return (acc / wacc).ravel(order="C").reshape(-1)


def save_vtk_vertex_field(
    mesh: StructuredMesh, field: np.ndarray, path: str, name: str = "value"
) -> None:
    """Write a vertex (point-data) field as a legacy-VTK rectilinear grid."""
    field = _host(field).ravel()
    d = mesh.dim
    axes = [mesh.axes[a] for a in range(d)] + [np.zeros(1)] * (3 - d)
    dims = [a.size for a in axes]
    npts = int(np.prod(dims))
    assert field.size == npts
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nparelagmc_tpu field\nASCII\n")
        f.write("DATASET RECTILINEAR_GRID\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        for label, a in zip(("X", "Y", "Z"), axes):
            f.write(f"{label}_COORDINATES {a.size} double\n")
            f.write(" ".join(f"{x:.10g}" for x in a) + "\n")
        f.write(f"POINT_DATA {npts}\n")
        f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        f.write("\n".join(f"{v:.10g}" for v in field) + "\n")


def save_field_glvis(
    mesh: StructuredMesh, field: np.ndarray, path: str
) -> None:
    """Write a P0 cell field as an MFEM GridFunction (GLVis format)."""
    field = _host(field).ravel()
    with open(path, "w") as f:
        f.write("FiniteElementSpace\n")
        f.write(f"FiniteElementCollection: L2_T1_{mesh.dim}D_P0\n")
        f.write("VDim: 1\nOrdering: 0\n\n")
        f.write("\n".join(f"{v:.10g}" for v in field) + "\n")
