"""The port's unstructured stack (parelagmc_tpu_torch/unstructured.py)
held against the JAX package's on generated meshes (tests/_torch_parity.py),
CPU, float64, the same numpy inputs: UnstructuredSPDESampler's noise,
eval and eval_pair (Jacobi-PCG and cg-mg, nested and agglomerated, tri and
tet) to 1e-10 at sampler rtol 1e-12; UnstructuredDarcySolver's solve_fwd
and solve_fwd_pair under minres-bj, minres-mg and minres-coefmg, mean-field
start on and off, Q to 1e-9 on variance-0.25 fields at Darcy rtol 1e-9,
iteration counts within 2 % (see assert_iterations); an MLMC run on a three-level tet hierarchy with the reference's
per-level sums (its pair step goes through the samplers' eval_pair), under
minres and under hybrid-cg (whose solver tests are in
tests/test_torch_hybrid.py). The JAX side is jitted (its eager while-loops are
slow)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, general_mesh, port_config, rel_err, to_np
from parelagmc_tpu import unstructured as jun
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import agglomeration as jagg
from parelagmc_tpu.fem import simplicial_hierarchy as jsh
from parelagmc_tpu.mesh import mfem_io as jmfem
from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
from parelagmc_tpu.utils.timing import TimeManager as JaxTimeManager
from parelagmc_tpu_torch import unstructured as tun
from parelagmc_tpu_torch.convert import simplicial_hierarchy_from_jax
from parelagmc_tpu_torch.fem import simplicial as tsimplicial
from parelagmc_tpu_torch.mesh import mfem_io as tmfem
from parelagmc_tpu_torch.uq import MLMCManager
from parelagmc_tpu_torch.utils.timing import TimeManager

F64 = torch.float64


def hierarchies(kind: str, build: str, nlevels: int):
    """(JAX hierarchy, the port's conversion of it): nested refinement of a
    coarse mesh or agglomeration of a fine one (tests/test_torch_simplicial.py
    holds the port's own builders equal to these)."""
    if build == "nested":
        base = {"tri": (2, 2), "tet": (1, 1, 1)}[kind]
        jh = jsh.build_simplicial_hierarchy(general_mesh(jmfem, base), nlevels)
    else:
        fine = {"tri": (8, 8), "tet": (2, 2, 2)}[kind]
        jh = jagg.build_agglomerated_hierarchy(general_mesh(jmfem, fine), nlevels,
                                               coarsening_factor=4)
    return jh, simplicial_hierarchy_from_jax(jh)


def config(**kw):
    cfg = ProblemConfig(variance=0.25, correlation_length=0.4, dtype="float64", **kw)
    cfg.sampler_solver.relative_tolerance = 1e-12
    cfg.sampler_solver.max_iterations = 2000
    cfg.darcy_solver.relative_tolerance = 1e-9
    cfg.darcy_solver.max_iterations = 3000
    return cfg


def sampled_fields(th, cfg, batch, seed):
    """Lognormal SPDE fields (variance 0.25, correlation length 0.4) on
    every level of `th`, each level's from its own noise, as numpy."""
    s = tun.UnstructuredSPDESampler(th, port_config(cfg), F64, device=CPU)
    return [to_np(s.eval(l, s.sample(l, (seed, l), batch))) for l in range(th.nlevels)]


@pytest.mark.parametrize("kind", ["tri", "tet"])
@pytest.mark.parametrize("build", ["nested", "agglomerated"])
@pytest.mark.parametrize("solver", ["cg-jacobi", "cg-mg"])
def test_sampler_matches_jax(kind, build, solver):
    jh, th = hierarchies(kind, build, 3)
    cfg = config()
    cfg.sampler_solver.name = solver
    js = jun.UnstructuredSPDESampler(jh, cfg, jnp.float64)
    ts = tun.UnstructuredSPDESampler(th, port_config(cfg), F64, device=CPU)
    assert (ts._mg[0] is not None) == (solver == "cg-mg")
    assert ts.nnz(0) == js.nnz(0) and ts.field_size(1) == js.field_size(1)
    key = jax.random.PRNGKey(7)
    xi_t = ts.sample(0, tuple(int(v) for v in np.asarray(jax.random.key_data(key))), 3)
    xi_j = js.sample(0, key, 3)
    np.testing.assert_allclose(to_np(xi_t), np.asarray(xi_j), rtol=1e-14)  # K2's plain version
    xi = np.asarray(xi_j)
    for level, xi_level in ((0, 0), (1, 0), (2, 0), (1, 1)):
        x = xi[:, : ts.sample_size(xi_level)]
        want = jax.jit(lambda v: js.eval(level, v, xi_level=xi_level))(jnp.asarray(x))
        got = ts.eval(level, torch.as_tensor(x), xi_level=xi_level)
        assert got.shape == (3, th.levels[level].n_s)
        assert rel_err(got, want) <= 1e-10, (level, xi_level)
    want = jax.jit(lambda v: js.eval_pair(0, v))(jnp.asarray(xi))
    got = ts.eval_pair(0, torch.as_tensor(xi))
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-10
    # The warm-started pair is the cold pair's fields.
    assert rel_err(got[1], ts.eval(1, torch.as_tensor(xi), xi_level=0)) <= 1e-9


@pytest.mark.parametrize("build", ["nested", "agglomerated"])
def test_sampler_operator_equals_jax(build):
    """The reduced SPD system with its essential rows eliminated (the port
    scales by diag(~ess) where the reference assigns into a LIL matrix)
    packs into the reference's ELL: the same columns, the same values,
    the same width, on every level of a three-level tet hierarchy."""
    jh, th = hierarchies("tet", build, 3)
    cfg = config()
    cfg.sampler_solver.name = "cg-jacobi"
    js = jun.UnstructuredSPDESampler(jh, cfg, jnp.float64)
    ts = tun.UnstructuredSPDESampler(th, port_config(cfg), F64, device=CPU)
    for lj, lt in zip(js._lv, ts._lv):
        np.testing.assert_array_equal(to_np(lt["A"].cols), np.asarray(lj["A"].cols))
        np.testing.assert_array_equal(to_np(lt["A"].vals), np.asarray(lj["A"].vals))
        np.testing.assert_array_equal(to_np(lt["dinv"]), np.asarray(lj["dinv"]))


SOLVERS = ["minres-bj", "minres-mg", "minres-coefmg"]


def assert_iterations(info_t, info_j, name):
    """Counts within 2 or 2 %; minres-mg within 10 %. The two packages
    differ by rounding alone, and MINRES's exit (the true-residual restart
    cycles) moves with it: on the nested minres-mg case a start vector
    perturbed by 6e-16 relative took level 1 from 176 to 191 iterations in
    the port, and the long solves here (100-600 iterations) part by 1-4."""
    n = int(info_j.iterations)
    slack = 0.1 * n if name == "minres-mg" else max(2, 0.02 * n)
    assert abs(info_t.iterations - n) <= slack, (info_t.iterations, n)


@pytest.mark.parametrize("build,meanfield", [("nested", False), ("agglomerated", False),
                                             ("nested", True)])
@pytest.mark.parametrize("name", SOLVERS)
def test_darcy_solver_matches_jax(build, meanfield, name):
    jh, th = hierarchies("tet", build, 3)
    cfg = config()
    cfg.darcy_solver.name = name
    cfg.darcy_solver.coarse_dense_cutoff = 20
    cfg.darcy_solver.meanfield_x0 = meanfield
    jsol = jun.UnstructuredDarcySolver(jh, cfg, jnp.float64)
    tsol = tun.UnstructuredDarcySolver(th, port_config(cfg), F64, device=CPU)
    assert [tsol.num_dofs(l) for l in range(3)] == [jsol.num_dofs(l) for l in range(3)]
    assert tsol.nnz(0) == jsol.nnz(0)
    assert (tsol._coef_mg[0] is not None) == (name == "minres-coefmg")
    assert (tsol._schur_mg[0] is not None) == (name == "minres-mg")
    if name == "minres-coefmg":
        assert len(tsol._coef_mg[0].levels) > 1  # the MG coarsens below the cutoff
    w = sampled_fields(th, cfg, 3, 11)
    for level in (0, 1):
        q_j, _, info_j, p_j = jax.jit(
            lambda v: jsol.solve_fwd(level, v, return_pressure=True))(jnp.asarray(w[level]))
        q_t, cost, info_t, p_t = tsol.solve_fwd(level, torch.as_tensor(w[level]),
                                                return_pressure=True)
        assert cost == tsol.num_dofs(level)
        assert rel_err(q_t, q_j) <= 1e-9 and rel_err(p_t, p_j) <= 1e-8
        assert_iterations(info_t, info_j, name)
        assert bool(info_t.converged.all())
    out_j = jax.jit(lambda a, b: jsol.solve_fwd_pair(0, a, b))(jnp.asarray(w[0]),
                                                             jnp.asarray(w[1]))
    out_t = tsol.solve_fwd_pair(0, torch.as_tensor(w[0]), torch.as_tensor(w[1]))
    assert rel_err(out_t[0], out_j[0]) <= 1e-9 and rel_err(out_t[1], out_j[1]) <= 1e-9
    assert_iterations(out_t[2], out_j[2], name)
    assert_iterations(out_t[3], out_j[3], name)
    # The warm-started fine solve gives the cold Q to solver tolerance.
    q_cold, _, _ = tsol.solve_fwd(0, torch.as_tensor(w[0]))
    assert rel_err(out_t[0], q_cold) <= 1e-8
    capped = tsol.solve_fwd(0, torch.as_tensor(w[0]), max_iters=2)[2]
    assert capped.iterations <= 2 and not bool(capped.converged.all())


def test_unconverged_samples_match_jax():
    """On the agglomerated levels of the 6-tet cube refined 4 times (the
    hierarchy of chip_smoke.py's phase 15), MINRES leaves some samples of
    a level-2 pair short of the 2-norm target after its restart cycles:
    the same samples in both packages, in float64 on the float32 sampler's
    fields, so the converged fraction the card reports there is the
    reference algorithm's."""
    gm = general_mesh(jmfem, (1, 1, 1))
    for _ in range(4):
        gm, _ = jsh.refine_simplicial(gm)
    jh = jagg.build_agglomerated_hierarchy(gm, 4, coarsening_factor=8)
    th = simplicial_hierarchy_from_jax(jh)
    cfg = ProblemConfig(refinements=3, correlation_length=0.3, variance=0.25, dtype="float64")
    cfg.darcy_solver.name = "minres-coefmg"
    cfg.darcy_solver.relative_tolerance = 1e-5
    cfg.darcy_solver.max_iterations = 800
    ts = tun.UnstructuredSPDESampler(th, port_config(cfg), torch.float32, device=CPU)
    tsol = tun.UnstructuredDarcySolver(th, port_config(cfg), F64, device=CPU)
    jsol = jun.UnstructuredDarcySolver(jh, cfg, jnp.float64)
    s_f, s_c = (s.double() for s in ts.eval_pair(2, ts.sample(2, (0, 123), 32)))
    got = tsol.solve_fwd_pair(2, s_f, s_c)
    want = jax.jit(lambda a, b: jsol.solve_fwd_pair(2, a, b))(jnp.asarray(to_np(s_f)),
                                                              jnp.asarray(to_np(s_c)))
    for i in (2, 3):
        np.testing.assert_array_equal(to_np(got[i].converged), np.asarray(want[i].converged))
        assert_iterations(got[i], want[i], "minres-coefmg")
    assert not bool(got[2].converged.all())
    # Solves to rtol 1e-5 whose exits may part by an iteration: Q to 1e-5.
    assert rel_err(got[0], want[0]) <= 1e-5 and rel_err(got[1], want[1]) <= 1e-5


def test_darcy_unit_coefficient_and_qois():
    """k = 1 on the unit cube gives Q = 1 (eff_perm) on every level of a
    nested hierarchy, and the p_int / local_avg_p functionals match the
    JAX package's."""
    jh, th = hierarchies("tet", "nested", 3)
    for qoi in ("eff_perm", "p_int", "local_avg_p"):
        cfg = config(qoi=qoi)
        jsol = jun.UnstructuredDarcySolver(jh, cfg, jnp.float64)
        tsol = tun.UnstructuredDarcySolver(th, port_config(cfg), F64, device=CPU)
        for level in range(3):
            np.testing.assert_allclose(to_np(tsol._lv[level]["obs"]),
                                       np.asarray(jsol._lv[level]["obs"]), rtol=1e-12)
            np.testing.assert_allclose(to_np(tsol._lv[level]["rhs"]),
                                       np.asarray(jsol._lv[level]["rhs"]), rtol=1e-12)
            if qoi == "eff_perm":
                q, _, _ = tsol.solve_fwd(level, torch.ones(1, th.levels[level].n_s, dtype=F64))
                np.testing.assert_allclose(float(q[0]), 1.0, rtol=1e-8)
    with pytest.raises(ValueError, match="unknown QoI"):
        tun.UnstructuredDarcySolver(th, port_config(config(qoi="nope")), F64, device=CPU)


def test_mlmc_three_level_tet_matches_jax(tmp_path):
    """tests/test_unstructured_ml.py::test_mlmc_on_cube_tet on the generated
    6-tet cube: the port's MLMCManager on the three-level nested hierarchy
    (384/48/6 tets) takes the JAX package's samples - its pair steps go
    through the sampler's eval_pair and the solver's solve_fwd_pair - and
    gives the same per-level sums."""
    JaxTimeManager.reset()
    TimeManager.reset()
    jh, th = hierarchies("tet", "nested", 3)
    cfg = config(refinements=2, mse=1e10, batch_size=8, initial_samples=8, cost_model="dofs",
                 output_filename=str(tmp_path / "tet.dat"))
    tcfg = port_config(cfg)
    jmgr = JaxMLMCManager(jun.UnstructuredDarcySolver(jh, cfg, jnp.float64),
                          jun.UnstructuredSPDESampler(jh, cfg, jnp.float64), cfg)
    sampler = tun.UnstructuredSPDESampler(th, tcfg, F64, device=CPU)
    calls = []
    pair = sampler.eval_pair
    sampler.eval_pair = lambda level, xi: calls.append(level) or pair(level, xi)
    mgr = MLMCManager(tun.UnstructuredDarcySolver(th, tcfg, F64, device=CPU), sampler, tcfg)
    assert list(mgr.M) == list(jmgr.M)
    jmgr.init_run([8, 8, 8])
    mgr.init_run([8, 8, 8])
    assert calls == [1, 0]
    np.testing.assert_array_equal(mgr.level_nsamples, [8, 8, 8])
    np.testing.assert_allclose(mgr.sums, jmgr.sums, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(mgr.solver_iterations, jmgr.solver_iterations, rtol=0.02)
    assert np.all(mgr.consistency[:2] < 1.0) and 0.2 < mgr.eQ[0] < 10.0
    mgr.close()
    jmgr.close()


def test_hybrid_cg_refused():
    """hybrid-cg, refused until the hybridized solver was ported, now
    builds and solves: every level of a nested tri hierarchy hybridizes
    (nothing runs MINRES in its place) and its Q equals minres-bj's on the
    same fields."""
    jh, th = hierarchies("tri", "nested", 2)
    cfg = config()
    cfg.darcy_solver.name = "hybrid-cg"
    tsol = tun.UnstructuredDarcySolver(th, port_config(cfg), F64, device=CPU)
    assert all(h is not None for h in tsol._hybrid)
    cfg.darcy_solver.name = "minres-bj"
    ref = tun.UnstructuredDarcySolver(th, port_config(cfg), F64, device=CPU)
    w = sampled_fields(th, cfg, 2, 4)
    for level in range(2):
        q, _, info = tsol.solve_fwd(level, torch.as_tensor(w[level]))
        q_ref, _, _ = ref.solve_fwd(level, torch.as_tensor(w[level]))
        assert bool(info.converged.all()) and rel_err(q, q_ref) <= 1e-8


def test_mlmc_hybrid_cg_matches_jax(tmp_path):
    """An MLMCManager run under hybrid-cg on a three-level agglomerated tet
    hierarchy (level 0 geometric, levels 1-2 algebraic): its level steps
    give the JAX package's Q and Qc per sample on the same keys, then the
    same per-level sums after init_run."""
    JaxTimeManager.reset()
    TimeManager.reset()
    jh, th = hierarchies("tet", "agglomerated", 3)
    cfg = config(refinements=2, mse=1e10, batch_size=8, initial_samples=8, cost_model="dofs",
                 output_filename=str(tmp_path / "hybrid.dat"))
    cfg.darcy_solver.name = "hybrid-cg"
    cfg.darcy_solver.coarse_dense_cutoff = 20
    tcfg = port_config(cfg)
    jsol = jun.UnstructuredDarcySolver(jh, cfg, jnp.float64)
    tsol = tun.UnstructuredDarcySolver(th, tcfg, F64, device=CPU)
    assert [h is not None for h in tsol._hybrid] == [h is not None for h in jsol._hybrid]
    assert all(h is not None for h in tsol._hybrid)
    jmgr = JaxMLMCManager(jsol, jun.UnstructuredSPDESampler(jh, cfg, jnp.float64), cfg)
    mgr = MLMCManager(tsol, tun.UnstructuredSPDESampler(th, tcfg, F64, device=CPU), tcfg)
    for level in (2, 1, 0):
        key = jax.random.fold_in(jax.random.PRNGKey(9), level)
        want = jmgr._step(level)(key)
        got = mgr._step(level)(tuple(int(v) for v in np.asarray(jax.random.key_data(key))))
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-8, atol=1e-12)
    jmgr.init_run([8, 8, 8])
    mgr.init_run([8, 8, 8])
    np.testing.assert_allclose(mgr.sums, jmgr.sums, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(mgr.solver_iterations, jmgr.solver_iterations, rtol=0.02)
    mgr.close()
    jmgr.close()


def test_single_level_and_own_builders():
    """A single SimplicialLevel is a one-level hierarchy; the port's own
    builders feed the sampler and solver as the converted ones do."""
    tm = general_mesh(tmfem, (3, 3))
    lvl = tsimplicial.build_simplicial_level(tm)
    cfg = port_config(config())
    s = tun.UnstructuredSPDESampler(lvl, cfg, F64, device=CPU)
    d = tun.UnstructuredDarcySolver(lvl, dataclasses.replace(cfg), F64, device=CPU)
    assert s.hierarchy.nlevels == d.hierarchy.nlevels == 1
    w = s.eval(0, s.sample(0, (0, 3), 2))
    q, _, info = d.solve_fwd(0, w)
    assert torch.isfinite(q).all() and bool(info.converged.all())
