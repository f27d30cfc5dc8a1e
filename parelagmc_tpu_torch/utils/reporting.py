"""Formatted per-level report tables and small analysis helpers.

The port's copy of parelagmc_tpu/utils/reporting.py (numpy host code): the
reference's Utilities report printers and helpers (src/Utilities.hpp:61-185)
- per-level dof/nnz/iteration tables, random-field error tables, the
center-of-mass indicator vector and closest-cell lookup used by the sampler
validation examples, and the GLVis socket plot.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from parelagmc_tpu_torch.mesh.structured import StructuredMesh


def _table(title: str, cols, rows) -> str:
    lines = ["-" * 79, title, "-" * 79]
    lines.append("  ".join(f"{c:>16}" for c in cols))
    for r in rows:
        lines.append("  ".join(f"{x:>16.8g}" if isinstance(x, float) else f"{x:>16}" for x in r))
    lines.append("-" * 79)
    return "\n".join(lines)


def dofs_info_table(
    ndofs: Sequence[int],
    nnz: Optional[Sequence[int]] = None,
    iters: Optional[Sequence[float]] = None,
) -> str:
    """Per-level dof/NNZ/iteration table (OutputDofsInfo analog)."""
    cols = ["level", "dofs"]
    if nnz is not None:
        cols.append("nnz")
    if iters is not None:
        cols.append("iters")
    rows = []
    for l in range(len(ndofs)):
        r = [l, int(ndofs[l])]
        if nnz is not None:
            r.append(int(nnz[l]))
        if iters is not None:
            r.append(float(iters[l]))
        rows.append(r)
    return _table("Forward problem size per level", cols, rows)


def random_field_errors_table(
    exp_errors: Sequence[float], var_errors: Sequence[float]
) -> str:
    """Per-level expectation/variance L2-error table
    (ReduceAndOutputRandomFieldErrors analog, src/Utilities.hpp:177-185)."""
    rows = [
        [l, float(exp_errors[l]), float(var_errors[l])]
        for l in range(len(exp_errors))
    ]
    return _table(
        "Random field errors", ["level", "||E[s]-exact||", "||Var[s]-exact||"], rows
    )


def find_closest_cell(mesh: StructuredMesh, point) -> int:
    """Index of the cell whose center is closest to `point`
    (FindClosestPointID analog, src/Utilities.hpp:71-73)."""
    point = np.asarray(point, dtype=np.float64)[: mesh.dim]
    centers = mesh.cell_centers()
    return int(np.argmin(((centers - point[None, :]) ** 2).sum(axis=1)))


def chi_center_of_mass(mesh: StructuredMesh) -> np.ndarray:
    """Indicator vector of the cell containing the domain's center of mass
    (chi_center_of_mass analog, src/Utilities.hpp:75) - used by the sampler
    validation examples to track a single-point covariance column."""
    center = np.array([0.5 * (a[0] + a[-1]) for a in mesh.axes])
    chi = np.zeros(mesh.num_cells)
    chi[find_closest_cell(mesh, center)] = 1.0
    return chi


def glvis_plot(
    mesh: StructuredMesh,
    field: np.ndarray,
    host: str = "localhost",
    port: int = 19916,
    title: str = "parelagmc_tpu",
) -> bool:
    """Send a cell field to a running GLVis server over its socket protocol
    (reference: PDESampler::glvis_plot, src/PDESampler.cpp:757-770).
    Returns False (without raising) when no server is listening."""
    import socket

    from parelagmc_tpu_torch.utils.io_vtk import save_field_glvis, save_mesh_mfem
    import tempfile, os

    try:
        with tempfile.TemporaryDirectory() as td:
            mp, fp = os.path.join(td, "m.mesh"), os.path.join(td, "f.gf")
            save_mesh_mfem(mesh, mp)
            save_field_glvis(mesh, field, fp)
            payload = (
                "solution\n"
                + open(mp).read()
                + open(fp).read()
                + f"\nwindow_title '{title}'\n"
            )
        with socket.create_connection((host, port), timeout=2.0) as s:
            s.sendall(payload.encode())
        return True
    except OSError:
        return False
