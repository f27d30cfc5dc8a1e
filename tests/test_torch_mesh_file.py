"""The port's mesh-file path held against the JAX package's on generated
meshes and MFEM v1.0 files written into tmp_path (tests/_torch_parity.py;
nothing reads a reference mesh), CPU, float64, the same numpy inputs:

* native/ (the g++ geometry library, built at first use into
  parelagmc_tpu_torch/_build/) and transfer_integrators.py: the P0
  coupling, the intersection moments, the brute-force broad phase, element
  measures and the four mortar matrices equal the JAX package's on
  non-matching tri, tet and mixed tet/hex meshes, with the oracles of
  tests/test_native.py and tests/test_transfer_integrators.py that need no
  mesh file;
* match_embedded_cells, build_embedded_simplicial_hierarchies (refinement
  and agglomeration modes), UnstructuredEmbeddedSPDESampler and
  UnstructuredProjectionSPDESampler (orders 0 and 1, transfer_velocity) on
  the same noise, to 1e-10;
* build_problem on each branch of _build_from_mesh_file: the MLMC
  manager's level steps per sample and its sums after init_run, the ratio
  manager's per-batch r, rc, z, zc, and every ValueError of the
  reference under the same condition."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from _torch_parity import (
    CPU,
    general_mesh,
    port_config,
    rel_err,
    to_np,
    write_general_mesh,
)
from parelagmc_tpu import native as jnative
from parelagmc_tpu import transfer_integrators as jti
from parelagmc_tpu import unstructured as jun
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.simplicial import build_simplicial_level as jbuild_level
from parelagmc_tpu.mesh import make_box_mesh as jbox
from parelagmc_tpu.mesh import mfem_io as jmfem
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.uq import BayesianInverseProblem as JaxBIP
from parelagmc_tpu.uq import BayesRatioManager as JaxRatioManager
from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
from parelagmc_tpu.utils.timing import TimeManager as JaxTimeManager
from parelagmc_tpu_torch import native as tnative
from parelagmc_tpu_torch import transfer_integrators as tti
from parelagmc_tpu_torch import unstructured as tun
from parelagmc_tpu_torch.fem.simplicial import build_simplicial_level as tbuild_level
from parelagmc_tpu_torch.mesh import mfem_io as tmfem
from parelagmc_tpu_torch.mesh.factories import make_box_mesh as tbox
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager, MLMCManager
from parelagmc_tpu_torch.utils.timing import TimeManager

F64 = torch.float64


def key_data(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def mesh(module, d, kind):
    """The original mesh (2^d cells of the unit box, sides labelled), its
    matching embedding (4^d cells of [-0.5, 1.5]^d, the same spacing,
    material 1 inside the unit box), or a non-matching enlarged mesh (3^d
    cells of [-0.25, 1.25]^d)."""
    if kind == "orig":
        return general_mesh(module, (2,) * d)
    if kind == "embed":
        return general_mesh(module, (4,) * d, lengths=(2.0,) * d, label=False,
                            origin=(-0.5,) * d, material_box=(0.0, 1.0))
    return general_mesh(module, (3,) * d, lengths=(1.5,) * d, label=False, origin=(-0.25,) * d)


def assert_same_csr(a, b, tol=1e-13):
    a, b = a.toarray(), b.toarray()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300))


# -- native/ and transfer_integrators.py -----------------------------------------


@pytest.mark.parametrize("d", [2, 3])
def test_native_matches_jax(d):
    """mortar_p0_couple, mortar_moments, mesh_arrays, the brute-force broad
    phase and element_measure give the JAX package's arrays; the coupling
    covers each original cell exactly (its volume), on tet/tri pairs and
    on tets against hexes."""
    o_t, e_t = mesh(tmfem, d, "orig"), mesh(tmfem, d, "enlarge")
    o_j, e_j = mesh(jmfem, d, "orig"), mesh(jmfem, d, "enlarge")
    G = tnative.mortar_p0_couple(o_t, e_t)
    assert_same_csr(G, jnative.mortar_p0_couple(o_j, e_j))
    np.testing.assert_allclose(np.asarray(G.sum(axis=1)).ravel(), o_t.cell_volumes(), rtol=1e-12)
    for a, b in zip(tnative.mortar_moments(o_t, e_t), jnative.mortar_moments(o_j, e_j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13 * max(np.abs(b).max(), 1.0))
    kw = dict(origin=(-0.2,) * d, lengths=(1.4,) * d)
    box_t, box_j = tbox((3,) * d, **kw), jbox((3,) * d, **kw)
    G = tnative.mortar_p0_couple(o_t, box_t)
    assert_same_csr(G, jnative.mortar_p0_couple(o_j, box_j))
    np.testing.assert_allclose(float(G.sum()), 1.0, rtol=1e-12)
    small_t, small_j = tbox((2,) * d, lengths=(1.0,) * d), jbox((2,) * d, lengths=(1.0,) * d)
    for a, b in zip(tnative.mesh_arrays(box_t), jnative.mesh_arrays(box_j)):
        np.testing.assert_array_equal(a, b)
    pairs_t = tnative.detect_intersections_bruteforce(small_t, box_t, tol=-1e-9)
    pairs_j = jnative.detect_intersections_bruteforce(small_j, box_j, tol=-1e-9)
    for a, b in zip(pairs_t, pairs_j):
        np.testing.assert_array_equal(a, b)
    for e in range(box_t.num_cells):
        m = tnative.element_measure(box_t, e)
        assert m == jnative.element_measure(box_j, e)
        np.testing.assert_allclose(m, box_t.cell_volumes()[e], rtol=1e-12)


def _p1_mass(gm):
    """The P1 mass matrix by the exact simplex formula
    int lambda_a lambda_b = V (1 + delta_ab) / ((d+1)(d+2))."""
    conn = np.stack(gm.elements)
    d = gm.dim
    p = gm.vertices[conn]
    vol = np.abs(np.linalg.det(p[:, 1:] - p[:, :1])) / math.factorial(d)
    rows, cols, vals = [], [], []
    for a in range(d + 1):
        for b in range(d + 1):
            rows.append(conn[:, a])
            cols.append(conn[:, b])
            vals.append(vol * (1.0 + (a == b)) / ((d + 1) * (d + 2)))
    n = gm.vertices.shape[0]
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


@pytest.mark.parametrize("d", [2, 3])
def test_mortar_matrices_match_jax(d):
    """mortar_p1_couple, mortar_p1_p0_couple, rt0_interpolate_constant and
    mortar_rt0_couple equal the JAX package's on a non-matching pair; on
    one mesh the P1 and RT0 couplings are the mass matrices, and across the
    pair a linear scalar, a constant P0 field and a constant RT0 field are
    reproduced exactly."""
    o_t, e_t = mesh(tmfem, d, "orig"), mesh(tmfem, d, "enlarge")
    o_j, e_j = mesh(jmfem, d, "orig"), mesh(jmfem, d, "enlarge")
    B = tti.mortar_p1_couple(o_t, e_t)
    assert_same_csr(B, jti.mortar_p1_couple(o_j, e_j))
    f = lambda x: 0.3 + 1.7 * x[:, 0] - 0.9 * x[:, 1]
    proj = spla.spsolve(_p1_mass(o_t).tocsc(), B @ f(e_t.vertices))
    np.testing.assert_allclose(proj, f(o_t.vertices), rtol=1e-8, atol=1e-10)
    assert_same_csr(tti.mortar_p1_couple(o_t, o_t), _p1_mass(o_t), tol=1e-12)

    (Bt, lump_t), (Bj, lump_j) = tti.mortar_p1_p0_couple(o_t, e_t), jti.mortar_p1_p0_couple(o_j,
                                                                                           e_j)
    assert_same_csr(Bt, Bj)
    np.testing.assert_allclose(lump_t, lump_j, rtol=1e-13)
    np.testing.assert_allclose(Bt @ np.full(len(e_t.elements), 3.25) / lump_t, 3.25, rtol=1e-10)

    l1_t, l2_t = tbuild_level(o_t), tbuild_level(e_t)
    l1_j, l2_j = jbuild_level(o_j), jbuild_level(e_j)
    R = tti.mortar_rt0_couple(l1_t, l2_t)
    assert_same_csr(R, jti.mortar_rt0_couple(l1_j, l2_j))
    assert_same_csr(tti.mortar_rt0_couple(l1_t, l1_t), l1_t.mass_csr(), tol=1e-12)
    vec = np.array([0.7, -0.3, 1.1])[:d]
    u1, u2 = tti.rt0_interpolate_constant(l1_t, vec), tti.rt0_interpolate_constant(l2_t, vec)
    np.testing.assert_array_equal(u1, jti.rt0_interpolate_constant(l1_j, vec))
    proj = spla.spsolve(l1_t.mass_csr().tocsc(), R @ u2)
    np.testing.assert_allclose(proj, u1, rtol=1e-8, atol=1e-10)


def test_native_library_builds_at_first_use_into_the_build_dir(tmp_path, monkeypatch):
    """The library lands in parelagmc_tpu_torch/_build/ under a hashed
    name, none next to the source; a build writes a temporary name and
    renames it, and a failed build raises."""
    tnative.mortar_p0_couple(mesh(tmfem, 2, "orig"), mesh(tmfem, 2, "enlarge"))
    path = tnative.library_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tnative.__file__)))
    assert os.path.dirname(path) == tnative.BUILD_DIR == os.path.join(pkg, "_build")
    assert os.path.isfile(path)
    assert not [f for f in os.listdir(os.path.dirname(tnative.__file__)) if f.endswith(".so")]
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    built = tnative.build_library()
    assert os.path.dirname(built) == str(tmp_path / "build")
    assert os.listdir(tmp_path / "build") == [os.path.basename(built)]
    monkeypatch.setattr(tnative, "GXX_FLAGS", ("-O3", "-shared", "-fPIC", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build_library()


# -- embedded samplers -------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3])
def test_match_embedded_cells_matches_jax_and_refuses_a_mismatch(d):
    o_t, e_t = mesh(tmfem, d, "orig"), mesh(tmfem, d, "embed")
    o_j, e_j = mesh(jmfem, d, "orig"), mesh(jmfem, d, "embed")
    sel = tun.match_embedded_cells(o_t, e_t)
    np.testing.assert_array_equal(sel, jun.match_embedded_cells(o_j, e_j))
    assert len(sel) == len(o_t.elements)
    # Every cell of material 1: not a matching embedding.
    for m, e in ((tun, mesh(tmfem, d, "enlarge")), (jun, mesh(jmfem, d, "enlarge"))):
        with pytest.raises(ValueError, match="not a matching embedding"):
            m.match_embedded_cells(o_t if m is tun else o_j, e)
    # The original's cells in another order.
    for m, o, e in ((tun, o_t, e_t), (jun, o_j, e_j)):
        o.elements = o.elements[::-1]
        with pytest.raises(ValueError, match="do not match the original mesh"):
            m.match_embedded_cells(o, e)


def embedded_hierarchies(d, agglomerate):
    kw = dict(unstructured_coarsening=agglomerate, coarsening_factor=8)
    o_t, e_t = mesh(tmfem, d, "orig"), mesh(tmfem, d, "embed")
    o_j, e_j = mesh(jmfem, d, "orig"), mesh(jmfem, d, "embed")
    if agglomerate:  # the files are the finest meshes: refine them once first
        from parelagmc_tpu.fem.simplicial_hierarchy import refine_simplicial as jrefine
        from parelagmc_tpu_torch.fem.simplicial_hierarchy import refine_simplicial as trefine

        (o_t, _), (e_t, _) = trefine(o_t), trefine(e_t)
        (o_j, _), (e_j, _) = jrefine(o_j), jrefine(e_j)
    n = 3 if d == 2 else 2
    return (tun.build_embedded_simplicial_hierarchies(o_t, e_t, n, **kw),
            jun.build_embedded_simplicial_hierarchies(o_j, e_j, n, **kw))


def sampler_config(**kw):
    cfg = ProblemConfig(variance=0.25, correlation_length=0.4, dtype="float64", **kw)
    cfg.sampler_solver.relative_tolerance = 1e-12
    cfg.sampler_solver.max_iterations = 3000
    return cfg


@pytest.mark.parametrize("agglomerate", [False, True], ids=["refined", "agglomerated"])
@pytest.mark.parametrize("d", [2, 3])
def test_embedded_hierarchies_and_sampler_match_jax(d, agglomerate):
    """The selections equal the JAX package's and align the two meshes on
    every level (each original cell's volume is its embedded twin's); the
    embedded sampler's eval, embed_eval and eval_pair give the JAX
    package's fields on the same noise."""
    (oh, eh, sel), (joh, jeh, jsel) = embedded_hierarchies(d, agglomerate)
    n = oh.nlevels
    assert len(sel) == n == eh.nlevels == (3 if d == 2 else 2)
    for l in range(n):
        np.testing.assert_array_equal(sel[l], jsel[l])
        assert oh.levels[l].n_s == joh.levels[l].n_s == len(sel[l])
        np.testing.assert_allclose(oh.levels[l].W, eh.levels[l].W[sel[l]], rtol=1e-12)
    cfg = sampler_config()
    ts = tun.UnstructuredEmbeddedSPDESampler(oh, eh, sel, port_config(cfg), F64, device=CPU)
    js = jun.UnstructuredEmbeddedSPDESampler(joh, jeh, jsel, cfg, jnp.float64)
    assert ts.field_size(1) == js.field_size(1) and ts.sample_size(0) == js.sample_size(0)
    key = jax.random.PRNGKey(3)
    xi = np.asarray(js.sample(0, key, 3))
    # The noise on the embedded mesh: K2's plain version against jax.random
    # (erfinv implementations part in the last bits), then both samplers
    # take the JAX package's draw.
    np.testing.assert_allclose(to_np(ts.sample(0, key_data(key), 3)), xi, rtol=1e-13)
    x_t, x_j = torch.as_tensor(xi), jnp.asarray(xi)
    for level, xi_level in ((0, 0), (1, 0), (n - 1, n - 2)):
        x = xi[:, : ts.sample_size(xi_level)]
        for name in ("eval", "embed_eval"):
            want = jax.jit(lambda v: getattr(js, name)(level, v, xi_level=xi_level))(
                jnp.asarray(x))
            got = getattr(ts, name)(level, torch.as_tensor(x), xi_level=xi_level)
            assert rel_err(got, want) <= 1e-10, (name, level)
    got = ts.eval_pair(0, x_t)
    for a, b in zip(got, jax.jit(lambda v: js.eval_pair(0, v))(x_j)):
        assert rel_err(a, b) <= 1e-10


def projection_samplers(d, order, enlarge="enlarge"):
    from parelagmc_tpu.fem.simplicial_hierarchy import build_simplicial_hierarchy as jbuild
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy as tbuild

    cfg = sampler_config(projection_order=order)
    oh, eh = tbuild(mesh(tmfem, d, "orig"), 2), tbuild(enlarge(tmfem) if callable(enlarge)
                                                        else mesh(tmfem, d, enlarge), 2)
    joh, jeh = jbuild(mesh(jmfem, d, "orig"), 2), jbuild(enlarge(jmfem) if callable(enlarge)
                                                         else mesh(jmfem, d, enlarge), 2)
    return (lambda: tun.UnstructuredProjectionSPDESampler(oh, eh, port_config(cfg), F64,
                                                          device=CPU),
            lambda: jun.UnstructuredProjectionSPDESampler(joh, jeh, cfg, jnp.float64))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("d", [2, 3])
def test_projection_sampler_matches_jax(d, order):
    """The projection sampler (P0 coupling, or P1-P0 over the lumped P1
    mass and the vertex average) gives the JAX package's eval, embed_eval,
    project and eval_pair; a constant transfers exactly; an enlarged mesh
    that does not cover the original raises in both packages."""
    t_make, j_make = projection_samplers(d, order)
    ts, js = t_make(), j_make()
    assert ts.projection_order == order and ts.field_size(0) == js.field_size(0)
    key = jax.random.PRNGKey(4)
    xi = np.asarray(js.sample(0, key, 3))
    for level in (0, 1):
        x = xi[:, : ts.sample_size(level)]
        for name in ("eval", "embed_eval"):
            want = jax.jit(lambda v: getattr(js, name)(level, v))(jnp.asarray(x))
            assert rel_err(getattr(ts, name)(level, torch.as_tensor(x)), want) <= 1e-10
        ones = torch.full((2, ts.hierarchy.levels[level].n_s), 2.5, dtype=F64)
        np.testing.assert_allclose(to_np(ts.project(level, ones)), 2.5, rtol=1e-10)
        assert ts.transfer == ts.project
    got = ts.eval_pair(0, torch.as_tensor(xi))
    for a, b in zip(got, jax.jit(lambda v: js.eval_pair(0, v))(jnp.asarray(xi))):
        assert rel_err(a, b) <= 1e-10
    short = lambda m: general_mesh(m, (3,) * d, lengths=(0.9,) * d, label=False)
    t_make, j_make = projection_samplers(d, order, enlarge=short)
    for make in (t_make, j_make):
        with pytest.raises(ValueError, match="No intersection, no transfer! \\(level 0\\)"):
            make()


@pytest.mark.parametrize("d", [2, 3])
def test_transfer_velocity_matches_jax(d):
    """transfer_velocity (CG on the original RT0 mass over the RT0 mortar
    coupling) gives the JAX package's velocity, and a constant field's
    RT0 interpolant on the enlarged mesh lands on the original's."""
    t_make, j_make = projection_samplers(d, 0)
    ts, js = t_make(), j_make()
    vecs = np.array([[0.7, -0.3, 1.1], [-1.0, 0.5, 0.25]])[:, :d]
    for level in (0, 1):
        u = np.stack([tti.rt0_interpolate_constant(ts.hierarchy.levels[level], v) for v in vecs])
        v_t, info_t = ts.transfer_velocity(level, torch.as_tensor(u), rtol=1e-12,
                                           max_iterations=200)
        v_j, info_j = js.transfer_velocity(level, jnp.asarray(u), rtol=1e-12, max_iterations=200)
        assert bool(info_t.converged.all()) and abs(info_t.iterations - int(info_j.iterations)) <= 2
        assert rel_err(v_t, v_j) <= 1e-10
        want = np.stack([tti.rt0_interpolate_constant(ts.orig_hierarchy.levels[level], v)
                         for v in vecs])
        np.testing.assert_allclose(to_np(v_t), want, rtol=1e-8, atol=1e-10)


# -- build_problem on mesh files ----------------------------------------------------

BRANCHES = {
    # name: (files to write, config fields)
    "structured": ("inline_hex", dict()),
    "simplicial": ("orig", dict()),
    "simplicial-hybrid": ("orig", dict(solver="hybrid-cg")),
    "agglomerated-hybrid": ("orig", dict(unstructured_coarsening=True, solver="hybrid-cg")),
    "matching": ("orig+embed", dict(embedding="matching", solver="hybrid-cg")),
    "matching-agglomerated": ("orig+embed", dict(embedding="matching",
                                                 unstructured_coarsening=True)),
    "projection-0": ("orig+enlarge", dict(embedding="projection")),
    "projection-1": ("orig+enlarge", dict(embedding="projection", projection_order=1,
                                          solver="hybrid-cg")),
    "matern": ("orig", dict(sampler_name="matern", number_of_modes=20)),
    "analytic": ("orig", dict(sampler_name="analytic", number_of_modes=27)),
}


def write_files(tmp_path, files, d=3):
    """The mesh files of a branch; returns the original's path."""
    base = tmp_path / "cube.mesh"
    if files == "inline_hex":
        base.write_text("MFEM INLINE mesh v1.0\ntype = hex\nnx = 2\nny = 2\nnz = 2\n")
        return str(base)
    gm = mesh(tmfem, d, "orig")
    gm.boundary_attributes[:] = 1  # single attribute: build_problem labels the box sides
    write_general_mesh(base, gm)
    if "embed" in files:
        write_general_mesh(tmp_path / "cube_embed.mesh", mesh(tmfem, d, "embed"))
    if "enlarge" in files:
        write_general_mesh(tmp_path / "cube_enlarge.mesh", mesh(tmfem, d, "enlarge"))
    return str(base)


def file_config(path, solver=None, **kw):
    kw = dict(dict(refinements=1, variance=0.25, correlation_length=0.4, dtype="float64",
                   batch_size=8, initial_samples=8, mse=1e10, seed=3, cost_model="dofs",
                   output_filename=""), **kw)
    cfg = ProblemConfig(mesh=path, **kw)
    cfg.sampler_solver.relative_tolerance = 1e-12
    cfg.sampler_solver.max_iterations = 3000
    cfg.darcy_solver.relative_tolerance = 1e-10
    cfg.darcy_solver.max_iterations = 3000
    if solver is not None:
        cfg.darcy_solver.name = solver
    return cfg


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_build_problem_mesh_file_drives_mlmc_as_the_jax_package(tmp_path, branch):
    """build_problem on a generated mesh file builds the classes of the
    JAX package's branch, and MLMCManager's level steps give its Q and Qc
    per sample on the same keys, then the same sums after init_run."""
    JaxTimeManager.reset()
    TimeManager.reset()
    files, kw = BRANCHES[branch]
    cfg = file_config(write_files(tmp_path, files), **kw)
    jprob = jax_build_problem(cfg)
    prob = build_problem(port_config(cfg), device=CPU)
    assert type(prob.sampler).__name__ == type(jprob.sampler).__name__
    assert type(prob.solver).__name__ == type(jprob.solver).__name__
    assert (prob.embed_hierarchy is None) == (jprob.embed_hierarchy is None)
    assert [l.n_s for l in prob.hierarchy.levels] == [l.n_s for l in jprob.hierarchy.levels]
    if kw.get("solver") == "hybrid-cg":
        assert [h is None for h in prob.solver._hybrid] == [h is None for h in jprob.solver._hybrid]
        assert prob.solver._hybrid[0] is not None
    jmgr = JaxMLMCManager(jprob.solver, jprob.sampler, cfg)
    mgr = MLMCManager(prob.solver, prob.sampler, prob.config)
    for level in (1, 0):
        key = jax.random.fold_in(jax.random.PRNGKey(21), level)
        want = [np.asarray(x) for x in jmgr._step(level)(key)]
        got = [to_np(x) for x in mgr._step(level)(key_data(key))]
        for name, a, b in zip(("q", "qc"), got, want):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=f"{name} L{level}")
    jmgr.init_run([8, 8])
    mgr.init_run([8, 8])
    np.testing.assert_allclose(mgr.sums, jmgr.sums, rtol=1e-8, atol=1e-12)
    assert np.isfinite(mgr.eQ).all()
    mgr.close()
    jmgr.close()


@pytest.mark.parametrize("branch", ["matching", "projection-1"])
def test_build_problem_mesh_file_drives_the_ratio_manager(tmp_path, branch):
    """The ratio manager's per-batch r, rc, z, zc on a mesh-file problem
    equal the JAX package's on the same key."""
    JaxTimeManager.reset()
    TimeManager.reset()
    files, kw = BRANCHES[branch]
    cfg = file_config(write_files(tmp_path, files), batch_size=4, **kw)
    jprob = jax_build_problem(cfg)
    prob = build_problem(port_config(cfg), device=CPU)
    jbip = JaxBIP(jprob.solver, jprob.sampler, cfg, jprob.dtype)
    tbip = BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype)
    jbip.set_observational_data([0.5])
    tbip.set_observational_data([0.5])
    jmgr = JaxRatioManager(jbip, cfg)
    mgr = BayesRatioManager(tbip, prob.config)
    for level in (1, 0):
        key = jax.random.fold_in(jax.random.PRNGKey(5), level)
        want = [np.asarray(x) for x in jmgr._step(level)(key)]
        got = [to_np(x) for x in mgr._step(level)(key_data(key))]
        for name, a, b in zip(("r", "rc", "z", "zc"), got, want):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=f"{name} L{level}")


ERRORS = [
    ("inline_hex", dict(sampler_name="matern"), "plain SPDE sampler"),
    ("inline_hex", dict(embedding="matching"), "plain SPDE sampler"),
    ("orig+embed", dict(embedding="matching", sampler_name="matern"),
     "embedding requires the SPDE sampler"),
    ("orig", dict(embedding="matching"), "needs an enlarged mesh at '.*cube_embed.mesh'"),
    ("orig", dict(embedding="projection"), "needs an enlarged mesh at '.*cube_enlarge.mesh'"),
    ("orig+enlarge", dict(embedding="projection", unstructured_coarsening=True),
     "not wired yet"),
    ("orig", dict(sampler_name="nope"), "unknown sampler 'nope'"),
    ("orig", dict(qoi="nope"), "unknown QoI 'nope'"),
]


@pytest.mark.parametrize("files,kw,match", ERRORS)
def test_build_problem_mesh_file_raises_as_the_jax_package(tmp_path, files, kw, match):
    cfg = file_config(write_files(tmp_path, files), **kw)
    with pytest.raises(ValueError, match=match):
        jax_build_problem(cfg)
    with pytest.raises(ValueError, match=match):
        build_problem(port_config(cfg), device=CPU)


def test_build_problem_mesh_file_reader_errors_and_axis_order(tmp_path):
    """A missing mesh file raises the reader's error and an unknown header
    its ValueError, in both packages; axis_order is ignored with a warning."""
    missing = port_config(file_config(str(tmp_path / "missing.mesh")))
    with pytest.raises(FileNotFoundError):
        jax_build_problem(file_config(str(tmp_path / "missing.mesh")))
    with pytest.raises(FileNotFoundError):
        build_problem(missing, device=CPU)
    bad = tmp_path / "bad.mesh"
    bad.write_text("not a mesh\n")
    with pytest.raises(ValueError, match="unsupported mesh header"):
        build_problem(port_config(file_config(str(bad))), device=CPU)
    cfg = file_config(write_files(tmp_path, "orig"), axis_order="auto", refinements=0)
    with pytest.warns(UserWarning, match="ignored for mesh files"):
        prob = build_problem(port_config(cfg), device=CPU)
    assert prob.hierarchy.nlevels == 1 and prob.config.axis_order == "auto"
