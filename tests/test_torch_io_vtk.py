"""The port's utils/io_vtk.py and utils/reporting.py against the JAX
package's: the files written are byte-equal for the same mesh and field
(given as a numpy array or as a torch tensor), the vertex averages equal,
the report strings and helper values equal."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread count)
from parelagmc_tpu.mesh import factories as jfactories
from parelagmc_tpu.utils import io_vtk as jio
from parelagmc_tpu.utils import reporting as jrep
from parelagmc_tpu_torch.mesh import factories as tfactories
from parelagmc_tpu_torch.utils import io_vtk as tio
from parelagmc_tpu_torch.utils import reporting as trep

MESHES = {
    "square-4x3": dict(ncells=(4, 3), lengths=(2.0, 1.5)),
    "cube-3x4x2": dict(ncells=(3, 4, 2), lengths=(1.0, 2.0, 1.0)),
    "spe10-spacing-6x5x3": dict(ncells=(6, 5, 3), spacings=tfactories.SPE10_SPACING),
}


def _meshes(kind):
    return jfactories.make_box_mesh(**MESHES[kind]), tfactories.make_box_mesh(**MESHES[kind])


def _field(n, seed):
    return np.exp(np.random.default_rng(seed).normal(size=n))


def _inputs(field):
    """The field as numpy, as a float64 torch tensor, as a torch tensor with
    a leading batch axis of one (ravelled by the writers)."""
    t = torch.from_numpy(field.copy())
    return {"numpy": field, "torch": t, "torch-batch": t.reshape(1, -1)}


@pytest.mark.parametrize("kind", list(MESHES))
def test_written_files_are_byte_equal(tmp_path, kind):
    jm, tm = _meshes(kind)
    cells = _field(tm.num_cells, 0)
    nverts = int(np.prod([a.size for a in tm.axes]))
    verts = _field(nverts, 1)

    def write(module, mesh, tag, cell_field, vert_field):
        d = tmp_path / tag
        d.mkdir()
        module.save_vtk_cell_field(mesh, cell_field, str(d / "c.vtk"), name="perm")
        module.save_vtk_vertex_field(mesh, vert_field, str(d / "v.vtk"))
        module.save_field_glvis(mesh, cell_field, str(d / "f.gf"))
        module.save_mesh_mfem(mesh, str(d / "m.mesh"))
        return {f: (d / f).read_bytes() for f in ("c.vtk", "v.vtk", "f.gf", "m.mesh")}

    ref = write(jio, jm, "jax", cells, verts)
    assert b"RECTILINEAR_GRID" in ref["c.vtk"] and b"CELL_DATA" in ref["c.vtk"]
    assert b"POINT_DATA %d" % nverts in ref["v.vtk"]
    cell_in, vert_in = _inputs(cells), _inputs(verts)
    for how in cell_in:
        assert write(tio, tm, how, cell_in[how], vert_in[how]) == ref, how


def test_mfem_output_refuses_1d_alike(tmp_path):
    jm, tm = (m.make_box_mesh((3,), lengths=(1.0,)) for m in (jfactories, tfactories))
    for module, mesh in ((jio, jm), (tio, tm)):
        with pytest.raises(ValueError, match="1D MFEM output not supported"):
            module.save_mesh_mfem(mesh, str(tmp_path / "m.mesh"))


@pytest.mark.parametrize("kind", list(MESHES))
def test_cell_to_vertex_average_matches(kind):
    jm, tm = _meshes(kind)
    cells = _field(tm.num_cells, 2)
    ref = jio.cell_to_vertex_average(jm, cells)
    for how, c in _inputs(cells).items():
        got = tio.cell_to_vertex_average(tm, c)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15, err_msg=how)
    np.testing.assert_allclose(tio.cell_to_vertex_average(tm, np.full(tm.num_cells, 3.5)), 3.5)


@pytest.mark.parametrize("kind", list(MESHES))
def test_reporting_matches(kind):
    """Tables, the closest cell, the center-of-mass indicator; and the GLVis
    plot returns False without a server, as the original does."""
    jm, tm = _meshes(kind)
    rng = np.random.default_rng(3)
    ndofs, nnz = [int(x) for x in rng.integers(10, 10 ** 6, 3)], [int(x) for x in
                                                                    rng.integers(10, 10 ** 7, 3)]
    iters = [float(x) for x in rng.uniform(1, 500, 3)]
    for args in ((ndofs,), (ndofs, nnz), (ndofs, None, iters), (ndofs, nnz, iters)):
        assert trep.dofs_info_table(*args) == jrep.dofs_info_table(*args)
    e, v = list(rng.uniform(0, 1, 3)), list(rng.uniform(0, 1, 3))
    assert trep.random_field_errors_table(e, v) == jrep.random_field_errors_table(e, v)
    lo = np.array([a[0] for a in tm.axes])
    hi = np.array([a[-1] for a in tm.axes])
    for p in rng.uniform(lo, hi, size=(8, len(lo))):
        assert trep.find_closest_cell(tm, p) == jrep.find_closest_cell(jm, p)
    # A point with more coordinates than the mesh has axes is cut to them.
    assert trep.find_closest_cell(tm, (0.1, 0.2, 0.3)) == jrep.find_closest_cell(jm, (0.1, 0.2, 0.3))
    chi = trep.chi_center_of_mass(tm)
    np.testing.assert_array_equal(chi, jrep.chi_center_of_mass(jm))
    assert chi.sum() == 1.0
    field = torch.from_numpy(_field(tm.num_cells, 4))
    assert trep.glvis_plot(tm, field, port=59999) is False
    assert jrep.glvis_plot(jm, field.numpy(), port=59999) is False
