"""Mesh factories: the box mesh and the SPE10 grid constants.

The port's own copy of the part of parelagmc_tpu/mesh/factories.py that
it calls (host-side numpy): make_box_mesh, the mfem::Mesh(nx, ny, nz, HEX,
sx, sy, sz) analog (the golden mesh is make_box_mesh((4, 4, 4),
lengths=(2, 2, 2)), and the SPE10 grid's cell counts and spacings
(60x220x85 cells of 20x10x2 ft). The embedded and Egg meshes stay out.
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


# -- SPE10 ----------------------------------------------------------------

SPE10_NCELLS = (60, 220, 85)
SPE10_SPACING = (20.0, 10.0, 2.0)  # feet
