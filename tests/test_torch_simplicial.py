"""The port's copies of the unstructured host builders held against the
JAX package's on generated meshes (tests/_torch_parity.py: a triangulated
square and a tet cube, boundary sides labelled as MFEM boxes): the MFEM
reader (v1.0 and inline), simplicial levels, refinement, nested and
agglomerated hierarchies (two and three levels), pack_ell and the box
labelling. Every array equal: integers exactly, floats to 1e-12."""

import dataclasses

import numpy as np
import pytest

from _torch_parity import general_mesh, simplex_box_arrays, write_mfem_v10
from parelagmc_tpu.fem import agglomeration as jagg
from parelagmc_tpu.fem import assembly as jassembly
from parelagmc_tpu.fem import simplicial as jsimplicial
from parelagmc_tpu.fem import simplicial_hierarchy as jsh
from parelagmc_tpu.mesh import mfem_io as jmfem
from parelagmc_tpu.unstructured import label_box_boundaries as jax_label_box_boundaries
from parelagmc_tpu_torch.convert import host_record_copy, simplicial_hierarchy_from_jax
from parelagmc_tpu_torch.fem import agglomeration as tagg
from parelagmc_tpu_torch.fem import assembly as tassembly
from parelagmc_tpu_torch.fem import simplicial as tsimplicial
from parelagmc_tpu_torch.fem import simplicial_hierarchy as tsh
from parelagmc_tpu_torch.mesh import mfem_io as tmfem
from parelagmc_tpu_torch.mesh.structured import StructuredMesh
from parelagmc_tpu_torch.unstructured import label_box_boundaries

MESHES = {"tri": (4, 3), "tet": (2, 2, 1)}


def assert_same(a, b, what):
    """Sparse, integer and float arrays (and lists of them) equal: ints
    exactly, floats to 1e-12."""
    if hasattr(a, "toarray"):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=1e-12, atol=1e-14,
                                   err_msg=what)
        return
    if isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def assert_records_equal(ja, ta, what):
    assert type(ja).__name__ == type(ta).__name__, what
    for f in dataclasses.fields(ja):
        x, y = getattr(ja, f.name), getattr(ta, f.name)
        if dataclasses.is_dataclass(x):
            assert_records_equal(x, y, f"{what}.{f.name}")
        elif f.name == "P_rt":
            assert_same(x, y, f"{what}.{f.name}")
        elif f.name == "levels":
            for l, (a, b) in enumerate(zip(x, y)):
                assert_records_equal(a, b, f"{what}.levels[{l}]")
            assert len(x) == len(y)
        else:
            assert_same(x, y, f"{what}.{f.name}")


def assert_hierarchies_equal(jh, th, nlevels):
    assert jh.nlevels == th.nlevels == nlevels
    assert_records_equal(jh, th, "hierarchy")
    for l in range(nlevels - 1):
        assert_same(jh.p_l2(l), th.p_l2(l), f"p_l2 {l}")
    for l, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        assert_same(jl.mass_csr(), tl.mass_csr(), f"mass {l}")
        assert_same(jl.b_csr(), tl.b_csr(), f"B {l}")
        ess = np.array([1, 0, 1, 0, 1, 1])
        assert_same(jl.ess_faces(ess), tl.ess_faces(ess), f"ess {l}")


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_read_mfem_v10_files(tmp_path, kind):
    """MFEM v1.0 text of a generated mesh: both readers give the same
    GeneralMesh (elements, attributes, geometry codes, boundary)."""
    verts, elements, boundary = simplex_box_arrays(MESHES[kind])
    d = verts.shape[1]
    rng = np.random.default_rng(0)
    path = write_mfem_v10(tmp_path / f"{kind}.mesh", d, verts, elements, 2 if d == 2 else 4,
                          boundary, 1 if d == 2 else 2,
                          attributes=rng.integers(1, 3, len(elements)),
                          battributes=rng.integers(1, 5, len(boundary)))
    jm, tm = jmfem.read_mfem_mesh(path), tmfem.read_mfem_mesh(path)
    assert isinstance(tm, tmfem.GeneralMesh)
    assert_records_equal(jm, tm, "GeneralMesh")
    np.testing.assert_array_equal(np.stack(tm.elements), elements)
    assert_same(jm.cell_centers(), tm.cell_centers(), "cell_centers")
    assert_same(jm.cell_volumes(), tm.cell_volumes(), "cell_volumes")
    np.testing.assert_allclose(tm.cell_volumes().sum(), 1.0, rtol=1e-12)


def test_read_mfem_structured_and_inline(tmp_path):
    """A tensor quad mesh in v1.0 text comes back as a StructuredMesh
    (try_as_structured, cell attributes carried); the inline format builds
    tri/tet GeneralMeshes and, for quad/hex, the port's own make_box_mesh."""
    axes = [np.array([0.0, 0.5, 1.5]), np.array([0.0, 1.0, 2.0, 2.5])]
    X, Y = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)
    vid = lambda i, j: i + 3 * j
    quads = [[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
             for j in range(3) for i in range(2)]
    attrs = np.arange(1, 7)
    path = write_mfem_v10(tmp_path / "quad.mesh", 2, verts, quads, 3, attributes=attrs)
    jm, tm = jmfem.read_mfem_mesh(path), tmfem.read_mfem_mesh(path)
    assert isinstance(tm, StructuredMesh) and tm.shape == jm.shape == (2, 3)
    for a, b in zip(jm.axes, tm.axes):
        assert_same(a, b, "axes")
    assert_same(jm.attributes, tm.attributes, "attributes")
    for typ, extra in (("tri", "nx = 3\nny = 2\nsx = 2.0\n"),
                       ("tet", "nx = 2\nny = 1\nnz = 2\nsz = 0.5\n"),
                       ("quad", "nx = 3\nny = 2\n"), ("hex", "nx = 2\nny = 2\nnz = 3\n")):
        p = tmp_path / f"inline_{typ}.mesh"
        p.write_text(f"MFEM INLINE mesh v1.0\n\ntype = {typ}\n{extra}")
        jm, tm = jmfem.read_mfem_mesh(str(p)), tmfem.read_mfem_mesh(str(p))
        if typ in ("tri", "tet"):
            assert_records_equal(jm, tm, f"inline {typ}")
        else:
            assert isinstance(tm, StructuredMesh) and tm.shape == jm.shape
            for a, b in zip(jm.axes, tm.axes):
                assert_same(a, b, f"inline {typ} axes")
    p = tmp_path / "bad.mesh"
    p.write_text("MFEM NC mesh v1.0\n")
    with pytest.raises(ValueError, match="unsupported mesh header"):
        tmfem.read_mfem_mesh(str(p))


def test_pack_ell_matches():
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 9, 60), rng.integers(0, 9, 60)
    vals, cells = rng.normal(size=60), rng.integers(0, 4, 60)
    for kw in (dict(cells=cells), dict(), dict(cells=cells, width=20)):
        got = tassembly.pack_ell(rows, cols, vals, 9, **kw)
        want = jassembly.pack_ell(rows, cols, vals, 9, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert_same(a, b, "pack_ell")
    with pytest.raises(ValueError, match="ELL width"):
        tassembly.pack_ell(rows, cols, vals, 9, width=2)


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_simplicial_level_matches(kind):
    """build_simplicial_level: face numbering, incidences, signs, the mass
    ELL, W and boundary attributes (box sides); label_box_boundaries."""
    jm, tm = general_mesh(jmfem, MESHES[kind]), general_mesh(tmfem, MESHES[kind])
    assert_same(jm.boundary_attributes, tm.boundary_attributes, "labelled sides")
    assert set(tm.boundary_attributes) == set(range(1, 2 * tm.dim + 1))
    jl, tl = jsimplicial.build_simplicial_level(jm), tsimplicial.build_simplicial_level(tm)
    assert_records_equal(jl, tl, f"{kind} level")
    np.testing.assert_allclose(tl.W.sum(), 1.0, rtol=1e-12)
    # The level-local relabelling of an unlabelled mesh.
    jl2 = jsimplicial.build_simplicial_level(general_mesh(jmfem, MESHES[kind], label=False))
    tl2 = tsimplicial.build_simplicial_level(general_mesh(tmfem, MESHES[kind], label=False))
    assert set(tl2.bdr_attr[tl2.bdr_attr > 0]) == {1}
    jax_label_box_boundaries(jl2)
    label_box_boundaries(tl2)
    assert_same(jl2.bdr_attr, tl2.bdr_attr, "label_box_boundaries")
    assert_same(tl2.bdr_attr, tl.bdr_attr, "both labellings")
    keys = np.sort(np.stack(tm.boundary), axis=1)
    uniq = np.unique(np.sort(np.concatenate(
        [np.delete(np.stack(tm.elements), i, axis=1) for i in range(tm.dim + 1)]), axis=1),
        axis=0)
    assert_same(jsimplicial._rows_lookup(uniq, keys), tsimplicial._rows_lookup(uniq, keys),
                "_rows_lookup")
    with pytest.raises(ValueError, match="not purely simplicial"):
        tsimplicial.build_simplicial_level(dataclasses.replace(
            tm, geom_types=np.full(len(tm.elements), 5, dtype=np.int32)))


@pytest.mark.parametrize("kind,nlevels", [("tri", 2), ("tri", 3), ("tet", 2), ("tet", 3)])
def test_nested_hierarchy_matches(kind, nlevels):
    """refine_simplicial and build_simplicial_hierarchy (levels, parent,
    P_rt, p_l2) from the same coarsest mesh; the exact embedding
    P^T M_f P = M_c holds in the port's copy."""
    base = {"tri": (2, 2), "tet": (1, 1, 1)}[kind]
    jm, tm = general_mesh(jmfem, base), general_mesh(tmfem, base)
    jf, jp = jsh.refine_simplicial(jm)
    tf, tp = tsh.refine_simplicial(tm)
    assert_records_equal(jf, tf, "refined mesh")
    assert_same(jp, tp, "parent")
    jh = jsh.build_simplicial_hierarchy(jm, nlevels)
    th = tsh.build_simplicial_hierarchy(tm, nlevels)
    assert_hierarchies_equal(jh, th, nlevels)
    nchild = 4 if kind == "tri" else 8
    assert [l.n_s for l in th.levels] == [tm.num_cells * nchild ** (nlevels - 1 - l)
                                          for l in range(nlevels)]
    P = th.P_rt[0]
    np.testing.assert_allclose((P.T @ th.levels[0].mass_csr() @ P).toarray(),
                               th.levels[1].mass_csr().toarray(), atol=1e-12)


@pytest.mark.parametrize("kind,nlevels", [("tri", 2), ("tri", 3), ("tet", 2), ("tet", 3)])
def test_agglomerated_hierarchy_matches(kind, nlevels):
    """build_agglomerated_hierarchy of a given fine mesh: every
    AgglomeratedLevel array (coarse faces, incidences, the minimum-energy
    mass ELL, W, boundary attributes, areas, centres), parents and P_rt;
    the port's converter reproduces the JAX package's hierarchy, and the
    coarse operators are Galerkin, B_c = P_l2^T B_f P_rt with +-1 entries."""
    fine = {"tri": (6, 6), "tet": (2, 2, 2)}[kind]
    jm, tm = general_mesh(jmfem, fine), general_mesh(tmfem, fine)
    jh = jagg.build_agglomerated_hierarchy(jm, nlevels, coarsening_factor=4)
    th = tagg.build_agglomerated_hierarchy(tm, nlevels, coarsening_factor=4)
    assert_hierarchies_equal(jh, th, nlevels)
    assert isinstance(th.levels[1], tagg.AgglomeratedLevel)
    assert th.levels[-1].n_s < th.levels[0].n_s
    assert_hierarchies_equal(jh, simplicial_hierarchy_from_jax(jh), nlevels)
    back = host_record_copy(th, type(jh), levels=[
        host_record_copy(l, type(jl), **({"mesh": host_record_copy(l.mesh, jmfem.GeneralMesh)}
                                          if hasattr(l, "mesh") else {}))
        for l, jl in zip(th.levels, jh.levels)])
    assert_hierarchies_equal(back, th, nlevels)
    for l in range(nlevels - 1):
        fl, cl = th.levels[l], th.levels[l + 1]
        Bc = (th.p_l2(l).T @ fl.b_csr() @ th.P_rt[l]).toarray()
        np.testing.assert_allclose(Bc, cl.b_csr().toarray(), atol=1e-10)
        assert_same(tagg._cell_adjacency(fl), jagg._cell_adjacency(jh.levels[l]), "adjacency")
        assert_same(tagg._level_cell_centers(fl), jagg._level_cell_centers(jh.levels[l]),
                    "centres")
        for a, b in zip(tagg._level_mass_triplets(fl), jagg._level_mass_triplets(jh.levels[l])):
            assert_same(a, b, "mass triplets")
    assert_same(tagg._level_face_areas(th.levels[0]), jagg._level_face_areas(jh.levels[0]),
                "face areas")
