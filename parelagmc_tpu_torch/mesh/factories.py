"""Mesh factories mirroring the reference's generated meshes.

The port's own copy of parelagmc_tpu/mesh/factories.py (host-side numpy,
no device code):

* make_box_mesh             - mfem::Mesh(nx, ny, nz, HEX, sx, sy, sz) analog
  (the golden mesh is make_box_mesh((4, 4, 4), lengths=(2, 2, 2))).
* make_embedded_box_mesh    - enlarged box shifted so it strictly contains
  the original; cells inside the original region keep attribute 1, the
  surrounding buffer gets attribute 2 (matching-mesh embedding).
* embedded_selection        - the map from original cells to embedded cells
  (the 0/1 selection of the embedded sampler in index form).
* make_spe10_mesh / make_embedded_spe10_mesh - the 60x220x85-cell SPE10 grid
  with 20x10x2 ft cells, and its enlarged version.
* make_egg_mesh             - embedded Egg-model grid, N = (60, 60, 7) cells
  of size (8, 8, 4) plus a buffer.
* shift_mesh                - translate grid coordinates.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from parelagmc_tpu_torch.mesh.structured import StructuredMesh


def make_box_mesh(
    ncells: Sequence[int],
    lengths: Optional[Sequence[float]] = None,
    origin: Optional[Sequence[float]] = None,
    spacings: Optional[Sequence[float]] = None,
) -> StructuredMesh:
    """Uniform box mesh with `ncells` cells per axis.

    Either `lengths` (total extent, default 1.0 per axis) or `spacings`
    (per-cell width) may be given.
    """
    ncells = [int(n) for n in ncells]
    d = len(ncells)
    if origin is None:
        origin = [0.0] * d
    if spacings is None:
        if lengths is None:
            lengths = [1.0] * d
        spacings = [float(L) / n for L, n in zip(lengths, ncells)]
    axes = [
        float(o) + float(h) * np.arange(n + 1, dtype=np.float64)
        for o, h, n in zip(origin, spacings, ncells)
    ]
    return StructuredMesh(axes)


def shift_mesh(mesh: StructuredMesh, *shifts: float) -> StructuredMesh:
    axes = [a + float(s) for a, s in zip(mesh.axes, shifts)]
    out = StructuredMesh(axes)
    out.attributes = mesh.attributes.copy()
    return out


def make_embedded_box_mesh(
    ncells: Sequence[int],
    lengths: Optional[Sequence[float]] = None,
    origin: Optional[Sequence[float]] = None,
    spacings: Optional[Sequence[float]] = None,
    n_buffer: Sequence[int] = (1,),
) -> StructuredMesh:
    """Enlarged mesh embedding the box mesh defined by the first arguments.

    The embedded mesh has ``ncells[a] + 2*n_buffer[a]`` cells along axis `a`
    with the same spacing, shifted so the central block coincides exactly
    with the original mesh. Central cells get attribute 1, buffer cells
    attribute 2.
    """
    ncells = [int(n) for n in ncells]
    d = len(ncells)
    if len(n_buffer) == 1:
        n_buffer = list(n_buffer) * d
    n_buffer = [int(n) for n in n_buffer]
    if origin is None:
        origin = [0.0] * d
    if spacings is None:
        if lengths is None:
            lengths = [1.0] * d
        spacings = [float(L) / n for L, n in zip(lengths, ncells)]
    big_n = [n + 2 * b for n, b in zip(ncells, n_buffer)]
    big_origin = [float(o) - b * h for o, b, h in zip(origin, n_buffer, spacings)]
    mesh = make_box_mesh(big_n, origin=big_origin, spacings=spacings)
    # Attribute 2 outside the original region, 1 inside.
    idx = mesh.cell_multi_index()
    inside = np.ones(mesh.num_cells, dtype=bool)
    for a in range(d):
        inside &= (idx[a] >= n_buffer[a]) & (idx[a] < n_buffer[a] + ncells[a])
    mesh.attributes = np.where(inside, 1, 2).astype(np.int32)
    return mesh


def embedded_selection(
    embedded: StructuredMesh, original: StructuredMesh
) -> np.ndarray:
    """(ne_original,) indices of the embedded cells matching each original
    cell (matching-mesh embedding). This is the per-level 0/1 selection
    operator of the reference's EmbeddedPDESampler
    (src/EmbeddedPDESampler.cpp:58-89) in index form: s_orig = s_embed[sel].
    """
    centers_e = embedded.cell_centers()
    inside = embedded.attributes == 1
    sel = np.nonzero(inside)[0]
    if sel.size != original.num_cells:
        raise ValueError(
            "embedded mesh attribute-1 region does not match original mesh "
            f"({sel.size} vs {original.num_cells} cells)"
        )
    # Both meshes enumerate cells lexicographically, so the attribute-1 cells
    # in embedded order are exactly the original cells in original order;
    # verify geometrically.
    centers_o = original.cell_centers()
    if not np.allclose(centers_e[sel], centers_o, atol=1e-12):
        raise ValueError("embedded mesh is not a matching embedding")
    return sel


# -- SPE10 ----------------------------------------------------------------

SPE10_NCELLS = (60, 220, 85)
SPE10_SPACING = (20.0, 10.0, 2.0)  # feet


def make_spe10_mesh(
    ndim: int = 3,
    ncells: Sequence[int] = SPE10_NCELLS,
    spacings: Sequence[float] = SPE10_SPACING,
) -> StructuredMesh:
    if ndim == 2:
        ncells, spacings = ncells[:2], spacings[:2]
    return make_box_mesh(ncells, spacings=spacings)


def make_embedded_spe10_mesh(
    ndim: int = 3,
    ncells: Sequence[int] = SPE10_NCELLS,
    spacings: Sequence[float] = SPE10_SPACING,
    n_buffer: Sequence[int] = (4, 4, 4),
) -> StructuredMesh:
    if ndim == 2:
        ncells, spacings, n_buffer = ncells[:2], spacings[:2], n_buffer[:2]
    return make_embedded_box_mesh(ncells, spacings=spacings, n_buffer=n_buffer)


# -- Egg model -------------------------------------------------------------

EGG_NCELLS = (60, 60, 7)
EGG_SPACING = (8.0, 8.0, 4.0)


def make_egg_mesh(
    element_size: Sequence[float] = EGG_SPACING,
    num_added_els: Sequence[int] = (4, 4, 4),
) -> StructuredMesh:
    """Embedded Egg-model grid (reference: Create_Embedded_EggModel_Mesh,
    src/MeshUtilities.cpp:157+): N = (60,60,7) cells of `element_size` plus
    `num_added_els` buffer layers per side."""
    return make_embedded_box_mesh(
        EGG_NCELLS, spacings=element_size, n_buffer=num_added_els
    )
