"""The port's spatially sharded Darcy solve (parallel/spatial_darcy.py) on the
CPU in float64, stacked form (every slab in this process, K1's plain
version): held to the port's own unsharded DarcySolver (itself held to the
JAX package in test_torch_darcy.py / test_torch_spe10.py) at the tolerances
of tests/test_spatial_darcy.py, to the JAX package's SpatialDarcy on the 8
virtual CPU devices of tests/conftest.py in one tier-1 case (the others
that run the JAX spatial solver are slow), and end to end through
DarcySolver's routing and MLMCManager. The torch.distributed form is held
to this one in tests/test_torch_spatial.py."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import build_geometric_hierarchy_from_fine as jax_hierarchy_from_fine
from parelagmc_tpu.mesh.factories import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.parallel.spatial_darcy import SpatialDarcy as JaxSpatialDarcy
from parelagmc_tpu.physics.darcy import DarcySolver as JaxDarcySolver
from parelagmc_tpu_torch.fem import build_geometric_hierarchy
from parelagmc_tpu_torch.fem.hierarchy import build_geometric_hierarchy_from_fine
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas_plain
from parelagmc_tpu_torch.parallel.slabs import StackedSlabs
from parelagmc_tpu_torch.parallel.spatial_darcy import SpatialDarcy, spike_tridiag_solve
from parelagmc_tpu_torch.physics import DarcySolver
from parelagmc_tpu_torch.samplers.pde import SPDESampler
from parelagmc_tpu_torch.uq import MLMCManager

N_SP = 8
F64 = torch.float64


def _spike_system(dtype, m=7, lines=5, seed=0):
    rng = np.random.default_rng(seed)
    n = N_SP * m
    d = 3.0 + rng.random((lines, n))
    dl = -rng.random((lines, n))
    du = -rng.random((lines, n))
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    b = rng.normal(size=(lines, n))
    # (lines, n) -> (slab, lines, m): each slab holds m consecutive rows.
    chunk = lambda a: torch.from_numpy(np.moveaxis(a.reshape(lines, N_SP, m), 1, 0).copy()).to(
        dtype)
    x = spike_tridiag_solve(chunk(dl), chunk(d), chunk(du), chunk(b), StackedSlabs(N_SP), dim=-1)
    return (dl, d, du, b), to_np(x.movedim(0, 1)).reshape(lines, n)


def test_spike_tridiag_exact():
    """The SPIKE reduction over 8 slabs is an exact solve (float64)."""
    (dl, d, du, b), x = _spike_system(F64)
    x_ref = np.stack([np.linalg.solve(np.diag(d[i]) + np.diag(du[i, :-1], 1)
                                      + np.diag(dl[i, 1:], -1), b[i]) for i in range(len(b))])
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)


def test_spike_tridiag_float32_against_thomas_on_the_whole_line():
    """In float32 the slab-cut solve agrees with one Thomas solve of each
    unsplit line (thomas_plain, K1's plain version) to float32 rounding."""
    (dl, d, du, b), x = _spike_system(torch.float32, seed=1)
    t = lambda a: torch.from_numpy(a.T.copy()).float()  # rows first
    ref = to_np(thomas_plain(t(dl), t(d), t(du), t(b))).T
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-5


def _build(ncells, kinv_contrast=None, seed=0, ess=(0, 1, 1, 1, 1, 0), name="cg-schur",
           rtol=1e-9, jax_too=False):
    """A one-level port DarcySolver on the unit box (and the JAX package's
    twin with `jax_too`), as tests/test_spatial_darcy.py builds it."""
    cfg = ProblemConfig(mesh="box", ncells=ncells, lengths=(1.0, 1.0, 1.0), refinements=0,
                        dtype="float64", ess_attr=ess)
    cfg.darcy_solver.name = name
    cfg.darcy_solver.relative_tolerance = rtol
    cfg.darcy_solver.max_iterations = 4000
    cfg.darcy_solver.local_schur_scaling = True
    kinv = None
    if kinv_contrast:
        rng = np.random.default_rng(seed)
        kinv = np.exp(rng.normal(size=(int(np.prod(ncells)), 3)) * np.log(kinv_contrast) / 4)
    spacings = [1.0 / n for n in ncells]
    hier = build_geometric_hierarchy_from_fine(make_box_mesh(ncells, spacings=spacings), 1)
    solver = DarcySolver(hier, port_config(cfg), F64, device=CPU, kinv_ref=kinv)
    if not jax_too:
        return hier, solver
    jhier = jax_hierarchy_from_fine(jax_make_box_mesh(ncells, spacings=spacings), 1)
    return hier, solver, JaxDarcySolver(jhier, cfg, jnp.float64, kinv_ref=kinv)


def _fields(hier, n, seed, sigma=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.exp(rng.normal(size=(n, hier.levels[0].n_s)) * sigma))


@pytest.mark.parametrize("pad_case", [False, True])
def test_sharded_matches_unsharded(pad_case):
    """ny = 16 (divides 8) and ny = 14 (padded by 2 identity planes): the
    sharded solve equals the unsharded exact-Schur solve."""
    hier, solver = _build((6, 14 if pad_case else 16, 5), kinv_contrast=50.0)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    assert sp.execution == "stacked" and sp.pad == (2 if pad_case else 0)
    w = _fields(hier, 3, 1)
    q_ref, _, info = solver.solve_fwd(0, w)
    q, iters, relres, conv = sp.solve_fwd(w)
    assert bool(info.converged.all()) and bool(conv.all())
    assert float(relres.max()) < 1e-8
    assert iters.shape == (3,) and bool((iters == iters[0]).all())
    np.testing.assert_allclose(to_np(q), to_np(q_ref), rtol=1e-6, atol=1e-9)


def test_sharded_flat_kinv_matches():
    hier, solver = _build((4, 16, 4))
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    w = _fields(hier, 2, 2, 0.3)
    q_ref, _, _ = solver.solve_fwd(0, w)
    q, _, relres, _ = sp.solve_fwd(w)
    assert float(relres.max()) < 1e-8
    np.testing.assert_allclose(to_np(q), to_np(q_ref), rtol=1e-6)


def test_cut_axis_requires_essential_y():
    hier, solver = _build((4, 8, 4), ess=(1, 0, 1, 1, 1, 1))
    with pytest.raises(ValueError, match="y boundaries"):
        SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)


def test_direct_construction_zeroes_essential_rhs():
    """A raw rhs with garbage on essential faces, passed to the constructor
    directly: the constructor zeroes those entries as DarcySolver does."""
    hier, solver = _build((4, 16, 4), kinv_contrast=10.0)
    L = solver.levels[0]
    rhs = to_np(L.rhs).copy()
    ess = to_np(L.ess)
    rhs[: L.n_u][ess] = 7.5
    sp = SpatialDarcy(hier.levels[0].mesh, solver.level_blocks(0),
                      np.asarray(solver.config.ess_attr[:6]), rhs, to_np(L.obs_func),
                      solver.sbar_diag_np(0), n_sp=N_SP, dtype=F64, max_iters=4000, rtol=1e-9,
                      ess=ess, device=CPU)
    w = _fields(hier, 2, 5, 0.3)
    q_ref, _, _ = solver.solve_fwd(0, w)
    q, _, rel, _ = sp.solve_fwd(w)
    assert float(rel.max()) < 1e-8
    np.testing.assert_allclose(to_np(q), to_np(q_ref), rtol=1e-6)


def test_warm_start_and_pressure_return():
    """The returned pressure is the unsharded one; a warm start from the
    true pressure takes 0 iterations (the warm path of solve_fwd_warm)."""
    hier, solver = _build((6, 16, 5), kinv_contrast=50.0)
    w = _fields(hier, 2, 3)
    q_ref, _, _, p_ref = solver.solve_fwd(0, w, return_pressure=True)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    _, _, _, _, p = sp.solve_fwd(w, return_pressure=True)
    np.testing.assert_allclose(to_np(p), to_np(p_ref), atol=1e-7)
    q2, it2, _, _ = sp.solve_fwd(w, p0=p_ref)
    assert int(it2.max()) == 0
    np.testing.assert_allclose(to_np(q2), to_np(q_ref), rtol=1e-9)


def test_sample_by_spatial_rows():
    """(dp, sp) = (2, 4): equal to the unsharded solve and, per sample, to
    the (1, 4) sharding; a batch that is not a multiple of n_dp is refused."""
    hier, solver = _build((6, 16, 5), kinv_contrast=50.0)
    w = _fields(hier, 4, 4)
    q_ref, _, _ = solver.solve_fwd(0, w)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=4, n_dp=2)
    q, it, rel, _ = sp.solve_fwd(w)
    assert float(rel.max()) < 1e-8
    np.testing.assert_allclose(to_np(q), to_np(q_ref), rtol=1e-6)
    q1, it1, _, _ = SpatialDarcy.from_darcy(solver, 0, n_sp=4).solve_fwd(w)
    np.testing.assert_allclose(to_np(q), to_np(q1), rtol=1e-12)
    assert torch.equal(it, it1)
    with pytest.raises(ValueError, match="multiple of n_dp"):
        sp.solve_fwd(w[:3])


def test_spatial_adjoint_corrected_qoi():
    """adjoint=True: at rtol 1e-3 the corrected Q lands near the deep truth
    where the plain loose solve does not; (p0, lam0) from a converged solve
    exit at once; lam0 without adjoint is refused."""
    hier, solver = _build((6, 16, 5), kinv_contrast=200.0)
    w = _fields(hier, 2, 5, 0.7)
    q_true = to_np(solver.solve_fwd(0, w)[0])
    solver.solver_cfg.relative_tolerance = 1e-3
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    q_plain = to_np(sp.solve_fwd(w)[0])
    q_adj, it, rel, _, p, lam = sp.solve_fwd(w, adjoint=True, return_pressure=True)
    e_plain = np.max(np.abs(q_plain - q_true) / np.abs(q_true))
    e_adj = np.max(np.abs(to_np(q_adj) - q_true) / np.abs(q_true))
    assert e_adj < 3e-4, (e_plain, e_adj)
    assert e_adj < 0.05 * e_plain, (e_plain, e_adj)
    q2, it2 = sp.solve_fwd(w, p0=p, lam0=lam, adjoint=True, return_pressure=True)[:2]
    assert int(it2.max()) == 0
    np.testing.assert_allclose(to_np(q2), to_np(q_adj), rtol=1e-9)
    with pytest.raises(ValueError, match="lam0 requires"):
        sp.solve_fwd(w, lam0=lam)


def _coefmg_case(ncells):
    cfg = ProblemConfig(mesh="box", ncells=ncells, lengths=(1.0, 1.0, 1.0), refinements=0,
                        dtype="float64")
    cfg.darcy_solver.name = "cg-schur-coefmg"
    cfg.darcy_solver.relative_tolerance = 1e-10
    cfg.darcy_solver.max_iterations = 4000
    rng = np.random.default_rng(7)
    kinv = np.exp(rng.normal(size=(int(np.prod(ncells)), 3)) * 3.0)  # ~1e5 contrast
    w = np.exp(rng.normal(size=(2, int(np.prod(ncells)))) * 0.5)
    return cfg, kinv, w


@pytest.mark.parametrize("ncells", [
    (8, 16, 6),
    pytest.param((12, 64, 10), marks=pytest.mark.slow),
    pytest.param((12, 60, 10), marks=pytest.mark.slow)])
def test_slab_coefmg_preconditioner(ncells):
    """cg-schur-coefmg: the two-level Schwarz slab coefMG. (8, 16, 6): m =
    2, one slab level, no global graft; (12, 64, 10): handoff level 1 with
    the global ladder; (12, 60, 10): ny padded by 4, zero-dinv faces
    through both ladders. The sharded solve equals the replicated one at
    rtol 1e-10 in fewer than 4x its iterations; the bfloat16 state keeps
    Q and about the iterations. (The two larger grids take 15-40 s each on
    this CPU: slow.)"""
    cfg, kinv, w = _coefmg_case(ncells)
    hier = build_geometric_hierarchy_from_fine(
        make_box_mesh(ncells, spacings=[1.0 / n for n in ncells]), 1)
    solver = DarcySolver(hier, port_config(cfg), F64, device=CPU, kinv_ref=kinv)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    assert sp.precond == "coefmg"
    assert (sp.global_mg is not None) == (ncells != (8, 16, 6))
    w = torch.from_numpy(w)
    q_ref, _, info = solver.solve_fwd(0, w)
    q, it, rel, conv = sp.solve_fwd(w)
    assert bool(conv.all()) and float(rel.max()) < 1e-9
    np.testing.assert_allclose(to_np(q), to_np(q_ref), rtol=1e-6)
    assert int(it.max()) < 4 * info.iterations
    if ncells == (8, 16, 6):
        solver.solver_cfg.coefmg_prec_dtype = "bfloat16"
        sp16 = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
        assert sp16.mg_prec_dtype == "bfloat16"
        q16, it16, _, _ = sp16.solve_fwd(w)
        np.testing.assert_allclose(to_np(q16), to_np(q_ref), rtol=1e-6)
        assert int(it16.max()) <= int(it.max()) * 1.3 + 2


def test_matches_jax_spatial_darcy():
    """Port against the JAX package's SpatialDarcy on (6, 16, 5) over 8
    slabs (the JAX one on 8 virtual CPU devices): the same iterations and
    Q to 1e-9."""
    hier, solver, jsolver = _build((6, 16, 5), kinv_contrast=50.0, jax_too=True)
    w = _fields(hier, 3, 1)
    q, it, rel, conv = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP).solve_fwd(w)
    jq, jit_, jrel, jconv = JaxSpatialDarcy.from_darcy(jsolver, 0, n_sp=N_SP).solve_fwd(
        jnp.asarray(to_np(w)))
    np.testing.assert_array_equal(to_np(it), np.asarray(jit_))
    np.testing.assert_array_equal(to_np(conv), np.asarray(jconv))
    assert rel_err(q, jq) < 1e-9


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["coefmg", "coefmg-bf16", "adjoint", "dp"])
def test_matches_jax_spatial_darcy_more(kind):
    """The slab coefMG (float64 and bfloat16 state), the adjoint-corrected
    QoI and the (dp, sp) = (2, 4) sharding against the JAX package's
    SpatialDarcy, each at its tests/test_spatial_darcy.py settings: Q to
    1e-7 and iterations within 2 (bfloat16: 10 %)."""
    if kind.startswith("coefmg"):
        ncells = (8, 16, 6)
        cfg, kinv, w = _coefmg_case(ncells)
        if kind.endswith("bf16"):
            cfg.darcy_solver.coefmg_prec_dtype = "bfloat16"
        spacings = [1.0 / n for n in ncells]
        solver = DarcySolver(build_geometric_hierarchy_from_fine(
            make_box_mesh(ncells, spacings=spacings), 1), port_config(cfg), F64, device=CPU,
            kinv_ref=kinv)
        jsolver = JaxDarcySolver(jax_hierarchy_from_fine(
            jax_make_box_mesh(ncells, spacings=spacings), 1), cfg, jnp.float64, kinv_ref=kinv)
        kw = {}
    elif kind == "adjoint":  # tests/test_spatial_darcy.py's adjoint case at rtol 1e-6
        hier, solver, jsolver = _build((6, 16, 5), kinv_contrast=200.0, jax_too=True,
                                       rtol=1e-6)
        w = to_np(_fields(hier, 4, 6, 0.7))
        kw = dict(adjoint=True)
    else:  # its (dp, sp) case: contrast 50, rtol 1e-9
        hier, solver, jsolver = _build((6, 16, 5), kinv_contrast=50.0, jax_too=True)
        w = to_np(_fields(hier, 4, 4))
        kw = {}
    n = dict(n_sp=4, n_dp=2) if kind == "dp" else dict(n_sp=N_SP)
    q, it = SpatialDarcy.from_darcy(solver, 0, **n).solve_fwd(torch.from_numpy(w), **kw)[:2]
    jq, jit_ = JaxSpatialDarcy.from_darcy(jsolver, 0, **n).solve_fwd(jnp.asarray(w), **kw)[:2]
    slack = max(2, int(0.1 * int(np.max(jit_)))) if kind.endswith("bf16") else 2
    assert abs(int(it.max()) - int(np.max(jit_))) <= slack
    assert rel_err(q, jq) < 1e-7


def _golden_mlmc(spatial, adjoint=False):
    """tests/test_spatial_darcy.py's MLMC config (the golden box refined
    once, cg-schur at rtol 1e-9), in both packages' config class."""
    cfg = ProblemConfig(refinements=1, mse=1e10, batch_size=8, initial_samples=8, seed=0,
                        output_filename="")
    cfg.darcy_solver.name = "cg-schur"
    cfg.darcy_solver.relative_tolerance = 1e-9
    cfg.darcy_solver.max_iterations = 2000
    cfg.darcy_solver.adjoint_qoi = adjoint
    if spatial:
        cfg.darcy_solver.spatial_shards = 4
        cfg.darcy_solver.spatial_sample_shards = 2
    return cfg


def _port_mlmc(cfg):
    tcfg = port_config(cfg)
    hier = build_geometric_hierarchy(make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2)
    solver = DarcySolver(hier, tcfg, F64, device=CPU)
    mgr = MLMCManager(solver, SPDESampler(hier, tcfg, F64, device=CPU), tcfg)
    mgr.init_run([8, 8])
    return mgr, solver


def _jax_mlmc(cfg):
    from parelagmc_tpu.fem import build_geometric_hierarchy as jbuild
    from parelagmc_tpu.mesh import make_box_mesh as jbox
    from parelagmc_tpu.samplers import SPDESampler as JaxSPDESampler
    from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
    from parelagmc_tpu.utils.timing import TimeManager

    TimeManager.reset()
    hier = jbuild(jbox((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2)
    mgr = JaxMLMCManager(JaxDarcySolver(hier, cfg, jnp.float64),
                         JaxSPDESampler(hier, cfg, jnp.float64), cfg)
    mgr.init_run([8, 8])
    return mgr


@pytest.mark.parametrize("adjoint", [False, True], ids=["plain", "adjoint"])
def test_mlmc_with_spatial_sharding(adjoint):
    """spatial_shards = 4 with spatial_sample_shards = 2 through the config
    alone: the finest level's cold, warm (pair) and adjoint solves go
    through SpatialDarcy, and the estimate and E[Y] equal the port's
    unsharded run and the JAX package's unsharded run."""
    mgr_sp, solver = _port_mlmc(_golden_mlmc(True, adjoint))
    assert solver._use_spatial(0) and not solver._use_spatial(1)
    assert solver.adjoint_pair_enabled(0) == adjoint
    (sp,) = solver._spatial_cache.values()
    assert (sp.n_sp, sp.n_dp, sp.execution) == (4, 2, "stacked")
    mgr_ref, _ = _port_mlmc(_golden_mlmc(False, adjoint))
    jmgr = _jax_mlmc(_golden_mlmc(False, adjoint))
    for ref in (mgr_ref, jmgr):
        np.testing.assert_allclose(mgr_sp.estimate, ref.estimate, rtol=1e-6)
        np.testing.assert_allclose(mgr_sp.eY, np.asarray(ref.eY), rtol=1e-5, atol=1e-9)


def test_spatial_with_auto_axis_order():
    """spatial_shards with axis_order="auto" on the scaled SPE10 grid:
    build_problem relabels the axes (and the ess_attr) before the solver
    cuts the relabelled y axis; Q equals the replicated solve's."""
    from parelagmc_tpu_torch.config import ProblemConfig as TorchConfig
    from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
    from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu_torch.problems import build_problem

    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))

    def make(spatial):
        cfg = TorchConfig(mesh="box", ncells=grid, lengths=lengths, refinements=0,
                          dtype="float64", axis_order="auto", correlation_length=100.0)
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.relative_tolerance = 1e-8
        cfg.darcy_solver.max_iterations = 8000
        if spatial:
            cfg.darcy_solver.spatial_shards = N_SP
        return build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=CPU)

    pr = make(False)
    assert pr.solver.hierarchy.levels[0].mesh.shape == (32, 16, 8)  # relabelled
    w = _fields(pr.solver.hierarchy, 2, 0, 0.3)
    q_ref = to_np(pr.solver.solve_fwd(0, w)[0])
    ps = make(True)
    q, _, info = ps.solver.solve_fwd(0, w)
    assert bool(info.converged.all())
    assert ps.solver._spatial(0).shape == (32, 16, 8)
    np.testing.assert_allclose(to_np(q), q_ref, rtol=1e-5)


def test_spatial_sample_shards_without_spatial_shards_warns():
    """The JAX package's warning: spatial_sample_shards > 1 does nothing
    unless spatial_shards > 1 (and none is given when it does)."""
    hier = build_geometric_hierarchy(make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0)), 1)
    cfg = port_config(ProblemConfig(refinements=0))
    cfg.darcy_solver.spatial_sample_shards = 2
    with pytest.warns(UserWarning, match="spatial_sample_shards > 1 has no effect"):
        DarcySolver(hier, cfg, F64, device=CPU)
    cfg.darcy_solver.spatial_shards = 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DarcySolver(hier, cfg, F64, device=CPU)


def test_spatial_shards_refused_under_minres_bj():
    hier = build_geometric_hierarchy(make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0)), 1)
    cfg = port_config(ProblemConfig(refinements=0))
    cfg.darcy_solver.name = "minres-bj"
    cfg.darcy_solver.spatial_shards = 2
    with pytest.raises(ValueError, match="cg-schur-family"):
        DarcySolver(hier, cfg, F64, device=CPU)


def test_budget_and_settings_reach_the_sharded_level():
    """solve_fwd's max_iters reaches the sharded solve (the managers' pair
    budget), and replacing solver_cfg rebuilds the SpatialDarcy at the new
    tolerance instead of answering with the old one."""
    hier, solver = _build((6, 16, 5), kinv_contrast=50.0)
    solver.solver_cfg = dataclasses.replace(solver.solver_cfg, spatial_shards=N_SP)
    w = _fields(hier, 2, 1)
    q, _, info = solver.solve_fwd(0, w, max_iters=3)
    assert info.iterations == 3 and not bool(info.converged.any())
    assert len(solver._spatial_cache) == 1
    q, _, info = solver.solve_fwd(0, w)
    assert bool(info.converged.all()) and len(solver._spatial_cache) == 1
    solver.solver_cfg = dataclasses.replace(solver.solver_cfg, relative_tolerance=1e-4)
    _, _, loose = solver.solve_fwd(0, w)
    assert len(solver._spatial_cache) == 2 and loose.iterations < info.iterations


@pytest.mark.parametrize("dim,R", [(3, 1), (1, 1), (2, 1), (2, 2)],
                         ids=["x-lines", "z-lines", "y-lines", "spike-R2"])
def test_grid_launch_addresses_the_slab_lines(dim, R):
    """K1's addressing of the slab layouts, on the CPU: the offsets that
    line_index computes from thomas_grid's launch (grid_launch) drive the
    plain recurrence over the flat tables and right-hand sides, and give
    thomas_grid_plain's solution - the x lines (last dim), the z lines (row
    stride m nx), the decoupled y lines (row stride nx) and the spike solves
    with two right-hand sides per table set."""
    from parelagmc_tpu_torch.ops.tridiag_pallas import grid_launch, line_index, thomas_grid_plain

    rng = np.random.default_rng(dim + R)
    shape = (3, 4, 5, 6)  # (slabs x samples, nz(+1), m, nx(+1))
    t = lambda: torch.from_numpy(rng.normal(size=shape))
    dl, du = -0.3 * t().abs(), -0.3 * t().abs()
    d = 2.0 + t().abs()
    b = torch.from_numpy(rng.normal(size=(shape[0], R) + shape[1:] if R > 1 else shape))
    want = thomas_grid_plain(dl, d, du, b, dim)
    lay, kw = grid_launch(shape, dim, R)
    lines, rows = torch.arange(lay.L)[:, None], torch.arange(lay.n)[None, :]
    tab = line_index(lay, lines, rows)  # (L, n) flat offsets of the tables
    got = torch.full_like(b.reshape(-1), float("nan"))
    for r in range(R):
        rb = line_index(lay, lines, rows, r, kw["rhs_stride"], kw["rhs_batch_stride"])
        x = thomas_plain(*(v.reshape(-1)[tab].T for v in (dl, d, du)), b.reshape(-1)[rb].T)
        got[rb] = x.T
    assert torch.equal(got.reshape(b.shape), want)

