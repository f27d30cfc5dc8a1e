"""The SPE10-scale structured path of the port held against the JAX package
on the CPU in float64: the SPE10 loader and production settings, the axis
relabeling of build_problem, the kinv_ref / Galerkin mass solver, the
masked mass diagonal, the cg-schur-coefmg Darcy solver (plain, adjoint,
meanfield, bfloat16 state, line smoother) on the SPE10 class at a small
non-dyadic grid, and the fixed-seed scaled SPE10 MLMC anchor."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu import problems as jproblems
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_mixed_level as jax_build_mixed_level
from parelagmc_tpu.fem.galerkin_mass import blocks_mass_csr
from parelagmc_tpu.fem.galerkin_mass import galerkin_block_chain as jax_galerkin_block_chain
from parelagmc_tpu.fem.hierarchy import (
    build_geometric_hierarchy_from_fine as jax_build_geometric_hierarchy_from_fine,
)
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import mass_solve as jms
from parelagmc_tpu.physics import DarcySolver as JaxDarcySolver
from parelagmc_tpu.physics import spe10 as jspe10
from parelagmc_tpu_torch import problems as tproblems
from parelagmc_tpu_torch.convert import darcy_level_from_jax, mass_solver_from_jax
from parelagmc_tpu_torch.fem import build_mixed_level
from parelagmc_tpu_torch.fem.galerkin_mass import galerkin_block_chain
from parelagmc_tpu_torch.fem.hierarchy import build_geometric_hierarchy_from_fine
from parelagmc_tpu_torch.mesh import SPE10_NCELLS, SPE10_SPACING, make_box_mesh
from parelagmc_tpu_torch.ops import mass_solve as tms
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.physics import DarcySolver
from parelagmc_tpu_torch.physics import spe10 as tspe10
from parelagmc_tpu_torch.uq import MLMCManager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.common import parse_config  # noqa: E402
from examples.spe10_mlmc import full_grid_solver_defaults as jax_full_grid_defaults  # noqa: E402

F64 = torch.float64
GRID = (12, 10, 7)  # non-dyadic: 7 -> 3 -> 1 coarsens with 3-cell tails


def _jax_solve(js, level, w, **kw):
    """The JAX package's solve_fwd under jit (eager while_loops dominate
    these tests' time otherwise)."""
    return jax.jit(lambda w: js.solve_fwd(level, w, **kw))(jnp.asarray(w))


# -- data and settings -----------------------------------------------------------


def test_synthetic_perm_and_kinv_match_jax():
    for ncells in ((6, 8, 5), GRID):
        np.testing.assert_array_equal(tspe10.synthetic_spe10_perm(ncells),
                                      jspe10.synthetic_spe10_perm(ncells))
        np.testing.assert_array_equal(tspe10.load_spe10_kinv(None, ncells),
                                      jspe10.load_spe10_kinv(None, ncells))
        np.testing.assert_array_equal(tspe10.load_spe10_kinv(None, ncells, slice_2d=2),
                                      jspe10.load_spe10_kinv(None, ncells, slice_2d=2))


def test_perm_file_reader_matches_jax(tmp_path, capsys):
    ncells = (3, 4, 2)
    k = np.exp(np.random.default_rng(0).normal(size=3 * 24))
    path = tmp_path / "spe_perm.dat"
    np.savetxt(path, k.reshape(-1, 6))
    np.testing.assert_array_equal(tspe10.read_spe_perm(str(path), ncells),
                                  jspe10.read_spe_perm(str(path), ncells))
    np.testing.assert_array_equal(tspe10.load_spe10_kinv(str(path), ncells),
                                  jspe10.load_spe10_kinv(str(path), ncells))
    # A missing file falls back to the synthetic field and says so.
    got = tspe10.load_spe10_kinv(str(tmp_path / "absent.dat"), ncells)
    np.testing.assert_array_equal(got, 1.0 / tspe10.synthetic_spe10_perm(ncells))
    assert "using synthetic permeability" in capsys.readouterr().err
    with pytest.raises(ValueError):
        tspe10.read_spe_perm(str(path), (5, 5, 5))


@pytest.mark.parametrize("opts", [[], ["adjoint_qoi=false"],
                                  ["max_iterations=40", "coefmg_prec_dtype=float32"]])
def test_full_grid_solver_defaults_match_example(opts):
    argv = ["--refinements", "2"] + [t for o in opts for t in ("--solver-opt", o)]
    kw = dict(mesh="spe10", correlation_length=100.0, normalize_marginals=True,
              axis_order="auto")
    ref = jax_full_grid_defaults(parse_config(argv, **kw), argv)
    got = tspe10.full_grid_solver_defaults(port_config(parse_config(argv, **kw)),
                                           overrides=[o.partition("=")[0] for o in opts])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.batch_size_per_level == [8, 128, 512]
    assert got.split_pair_programs and got.solve_segments == 4


# -- axis order ---------------------------------------------------------------------


@pytest.mark.parametrize("order", ["auto", (2, 0, 1), None])
def test_axis_relabeling_matches_jax(order):
    ncells = (4, 6, 3)
    rng = np.random.default_rng(1)
    assert (tproblems.resolve_axis_order(order, ncells)
            == jproblems.resolve_axis_order(order, ncells))
    perm = tproblems.resolve_axis_order(order, ncells)
    for field in (rng.normal(size=72), rng.normal(size=(72, 3))):
        np.testing.assert_array_equal(tproblems.permute_cell_field(field, ncells, perm),
                                      jproblems.permute_cell_field(field, ncells, perm))
    attrs = (1, 2, 3, 4, 5, 6)
    assert (tproblems.permute_side_attrs(attrs, perm)
            == jproblems._permute_side_attrs(attrs, perm))
    cfg = ProblemConfig(ncells=(1, 2, 3), lengths=(4.0, 5.0, 6.0), qoi_point=(0.1, 0.2, 0.3),
                        bayes_obs_coords=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0), axis_order=order)
    cfg.darcy_solver.coefmg_line_axes = "zx"
    assert (dataclasses.asdict(tproblems.permute_config_axes(port_config(cfg), perm))
            == dataclasses.asdict(jproblems._permute_config_axes(cfg, perm)))
    with pytest.raises(ValueError):
        tproblems.resolve_axis_order((0, 0, 1), ncells)


def test_spe10_mesh_spec_and_auto_order():
    cfg = ProblemConfig(mesh="spe10", refinements=2)
    assert tproblems.fine_mesh_spec(port_config(cfg)) == jproblems.fine_mesh_spec(cfg)
    ncells, _ = tproblems.fine_mesh_spec(cfg)
    assert ncells == (60, 220, 85)
    assert tproblems.resolve_axis_order("auto", ncells) == (1, 0, 2)


def _coefmg_cfg(**kw):
    cfg = ProblemConfig(mesh="box", ncells=(3, 5, 2), lengths=(60.0, 100.0, 8.0),
                        refinements=1, correlation_length=30.0, dtype="float64",
                        output_filename="", **kw)
    cfg.normalize_marginals = True
    ds = cfg.darcy_solver
    ds.name = "cg-schur-coefmg"
    ds.relative_tolerance = 1e-10
    ds.max_iterations = 1000
    ds.coarse_dense_cutoff = 20
    return cfg


def test_build_problem_with_auto_axis_order_matches_jax():
    """axis_order='auto' on a box with a kinv_ref: the relabeled config,
    the hierarchy, the sampler's fields from one noise draw and the coefMG
    solve agree with the JAX package's build_problem."""
    cfg = _coefmg_cfg(axis_order="auto")
    cfg.darcy_solver.coefmg_line_axes = "z"
    kinv = tspe10.load_spe10_kinv(None, ncells=(6, 10, 4))
    jp = jproblems.build_problem(cfg, kinv_ref=kinv)
    tp = tproblems.build_problem(port_config(cfg), kinv_ref=kinv, device=CPU)
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)
    assert tp.hierarchy.levels[0].mesh.shape == (10, 6, 4)
    assert tp.solver.levels[0].coef_mg.line_axes == (2,)
    xi = tp.sampler.sample(0, PRNGKey(3), 2)
    for level in (0, 1):
        s_t = tp.sampler.eval(level, xi, xi_level=0)
        s_j = jp.sampler.eval(level, jnp.asarray(to_np(xi)), xi_level=0)
        assert rel_err(s_t, s_j) < 1e-12
        q_t, _, i_t = tp.solver.solve_fwd(level, s_t)
        q_j, _, i_j = _jax_solve(jp.solver, level, to_np(s_t))
        assert rel_err(q_t, q_j) < 1e-9 and abs(i_t.iterations - int(i_j.iterations)) <= 2


# -- mass solve with kinv_ref / Galerkin blocks -----------------------------------


def _hierarchy(nlevels=3):
    fine = make_box_mesh(GRID, spacings=SPE10_SPACING)
    return build_geometric_hierarchy_from_fine(fine, nlevels)


def _jax_hierarchy(nlevels=3):
    fine = jax_make_box_mesh(GRID, spacings=SPE10_SPACING)
    return jax_build_geometric_hierarchy_from_fine(fine, nlevels)


def test_galerkin_mass_solver_matches_jax_and_dense():
    hier, jhier = _hierarchy(), _jax_hierarchy()
    kinv = tspe10.load_spe10_kinv(None, ncells=GRID)
    chain, _ = galerkin_block_chain([lvl.mesh for lvl in hier.levels], kinv)
    jchain, _ = jax_galerkin_block_chain([lvl.mesh for lvl in jhier.levels], kinv)
    rng = np.random.default_rng(2)
    ess_attr = np.array([0, 1, 1, 1, 1, 0])
    for l, (lvl, jlvl) in enumerate(zip(hier.levels, jhier.levels)):
        ess = lvl.ess_faces(ess_attr)
        mine = tms.build_mass_tridiag_solver(lvl, ess, dtype=F64, device=CPU,
                                             axis_blocks=chain[l])
        jsol = jms.build_mass_tridiag_solver(jlvl, ess, dtype=jnp.float64, axis_blocks=jchain[l])
        for a, b in zip(mine.axes, mass_solver_from_jax(jsol, device=CPU).axes):
            for name in ("m_lo", "m_mid", "m_hi", "ess"):
                assert torch.equal(getattr(a, name), getattr(b, name)), (l, name)
        w = np.exp(rng.normal(size=(2, lvl.n_s)))
        rhs = rng.normal(size=(2, lvl.n_u))
        rhs[:, ess] = 0.0
        got = to_np(mine(torch.from_numpy(w), torch.from_numpy(rhs)))
        ref = np.asarray(jsol(jnp.asarray(w), jnp.asarray(rhs)))
        assert rel_err(got, ref) < 1e-12
        if l > 0:  # coarse Galerkin blocks: bll != brr
            assert not np.allclose(chain[l][0], chain[l][2])
        M = blocks_mass_csr(jlvl, jchain[l], w[0]).toarray()
        M[ess, :] = 0.0
        M[:, ess] = 0.0
        M[np.nonzero(ess)[0], np.nonzero(ess)[0]] = 1.0
        np.testing.assert_allclose(M @ got[0], rhs[0], atol=1e-9 * np.abs(rhs).max())


def test_kinv_mass_solver_matches_jax():
    args = ((5, 4, 3), (1.0, 2.0, 0.5))
    lvl = build_mixed_level(make_box_mesh(*args))
    jlvl = jax_build_mixed_level(jax_make_box_mesh(*args))
    ess = lvl.ess_faces(np.array([1, 0, 1, 0, 1, 1]))
    rng = np.random.default_rng(3)
    w = np.exp(rng.normal(size=(2, lvl.n_s)))
    rhs = rng.normal(size=(2, lvl.n_u))
    for kinv in (np.exp(rng.normal(size=(lvl.n_s, 3))), np.exp(rng.normal(size=lvl.n_s))):
        mine = tms.build_mass_tridiag_solver(lvl, ess, kinv_ref=kinv, dtype=F64, device=CPU)
        jsol = jms.build_mass_tridiag_solver(jlvl, ess, kinv_ref=kinv, dtype=jnp.float64)
        got = to_np(mine(torch.from_numpy(w), torch.from_numpy(rhs)))
        assert rel_err(got, np.asarray(jsol(jnp.asarray(w), jnp.asarray(rhs)))) < 1e-12


# -- Darcy, cg-schur-coefmg + kinv_ref --------------------------------------------

VARIANTS = {
    "plain": dict(),
    "adjoint": dict(adjoint_qoi=True),
    "lines": dict(coefmg_line_axes="auto", coefmg_cheby_order=3, coefmg_cheby_lo=0.1),
    "cycles2": dict(coefmg_cycles=2, coefmg_sweeps=3),
}


def _spe10_solvers(coarse_operators="galerkin", *, kinv_power=1.0, rtol=1e-8, max_iters=2000,
                   mg_cutoff=None, **solver_kw):
    """(hierarchy, JAX solver, port solver) on the SPE10 class with its
    synthetic kinv_ref raised to kinv_power. mg_cutoff is
    sampler_solver.coarse_dense_cutoff, which the static Schur MG reads."""
    hier = _hierarchy()
    cfg = ProblemConfig(refinements=2, coarse_operators=coarse_operators)
    if mg_cutoff is not None:
        cfg.sampler_solver.coarse_dense_cutoff = mg_cutoff
    ds = cfg.darcy_solver
    ds.name = "cg-schur-coefmg"
    ds.relative_tolerance = rtol
    ds.max_iterations = max_iters
    ds.coarse_dense_cutoff = 20
    for k, v in solver_kw.items():
        setattr(ds, k, v)
    kinv = tspe10.load_spe10_kinv(None, ncells=GRID) ** kinv_power
    return (hier, JaxDarcySolver(_jax_hierarchy(), cfg, jnp.float64, kinv_ref=kinv),
            DarcySolver(hier, port_config(cfg), F64, device=CPU, kinv_ref=kinv))


@pytest.mark.parametrize("coarse_operators", ["galerkin", "rediscretize"])
def test_kinv_levels_equal_converted_jax(coarse_operators):
    hier, js, ts = _spe10_solvers(coarse_operators, coefmg_line_axes="auto")
    for l in range(3):
        a, b = ts.levels[l], darcy_level_from_jax(js.levels[l], device=CPU)
        for name in ("rhs", "obs_func"):
            assert rel_err(getattr(a, name), getattr(b, name)) < 1e-13, (l, name)
        assert a.coef_mg == b.coef_mg
        for xa, xb in zip(a.mass_solver.axes, b.mass_solver.axes):
            for name in ("m_lo", "m_mid", "m_hi", "ess"):
                assert torch.equal(getattr(xa, name), getattr(xb, name)), (l, name)


def test_masked_mass_diagonal_equals_jax_m_diag():
    """L.m_diag(w) of the reference's ELL (essential faces 0) equals the
    diagonal read off the port's factor(w) tables."""
    hier, js, ts = _spe10_solvers()
    rng = np.random.default_rng(4)
    for l in range(3):
        w = np.exp(rng.normal(size=(3, hier.levels[l].n_s)))
        ref = np.asarray(js.levels[l].m_diag(jnp.asarray(w)))
        ms = ts.levels[l].mass_solver
        got = ms.masked_diag(ms.factor(torch.from_numpy(w)), (3,))
        assert rel_err(got, ref) < 1e-15
        assert (to_np(got)[:, np.asarray(js.levels[l].ess)] == 0).all()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_coefmg_solve_matches_jax(variant):
    hier, js, ts = _spe10_solvers(**VARIANTS[variant])
    rng = np.random.default_rng(5)
    adjoint = VARIANTS[variant].get("adjoint_qoi", False)
    for level in (0, 1):
        w = np.exp(0.5 * rng.normal(size=(3, hier.levels[level].n_s)))
        ref = _jax_solve(js, level, w, return_pressure=True, return_adjoint=adjoint)
        got = ts.solve_fwd(level, torch.from_numpy(w), return_pressure=True,
                           return_adjoint=adjoint)
        assert bool(got[2].converged.all())
        assert abs(got[2].iterations - int(ref[2].iterations)) <= 2
        assert rel_err(got[0], ref[0]) < 1e-6
        assert rel_err(got[3], ref[3]) < 1e-5
        if adjoint:
            assert rel_err(got[4], ref[4]) < 1e-5


def test_adjoint_pair_with_meanfield_matches_jax():
    """The production pair: adjoint QoI, the coarse member cold from the
    cached mean-field iterates, the fine member warm from the coarse
    pressure and adjoint."""
    hier, js, ts = _spe10_solvers(adjoint_qoi=True, meanfield_x0=True)
    assert ts.adjoint_pair_enabled(0)
    rng = np.random.default_rng(6)
    w_f = np.exp(0.5 * rng.normal(size=(2, hier.levels[0].n_s)))
    w_c = np.exp(0.5 * rng.normal(size=(2, hier.levels[1].n_s)))
    ref = jax.jit(lambda a, b: js.solve_fwd_pair(0, a, b))(jnp.asarray(w_f), jnp.asarray(w_c))
    got = ts.solve_fwd_pair(0, torch.from_numpy(w_f), torch.from_numpy(w_c))
    for k in (0, 1):
        assert rel_err(got[k], ref[k]) < 1e-6
    for k in (2, 3):
        assert abs(got[k].iterations - int(ref[k].iterations)) <= 2
    # Meanfield: one cached w = 1 solve per level (pressure and adjoint).
    assert set(ts._mf_cache) == {1}
    p_ref, lam_ref = ts._mf_cache[1]
    assert p_ref.shape == (hier.levels[1].n_s,) and lam_ref is not None
    # solve_fwd_x0 from a converged iterate needs (almost) no iterations.
    q, _, info, p, lam = ts.solve_fwd(0, torch.from_numpy(w_f), return_pressure=True,
                                      return_adjoint=True)
    q2, _, info2 = ts.solve_fwd_x0(0, torch.from_numpy(w_f), p, lam0=lam)
    assert info2.iterations <= 2 and rel_err(q2, q) < 1e-8


def test_coefmg_bfloat16_state_matches_jax():
    """coefmg_prec_dtype=bfloat16: the V-cycle in bf16, the CG in float64.
    The two packages round bf16 differently, so iterations agree to 10 %;
    the converged Q still agrees to 1e-6."""
    hier, js, ts = _spe10_solvers(coefmg_prec_dtype="bfloat16", coefmg_cheby_order=3,
                                  coefmg_cheby_lo=0.1, coefmg_line_axes="auto")
    rng = np.random.default_rng(7)
    for level in (0, 1):
        w = np.exp(0.5 * rng.normal(size=(3, hier.levels[level].n_s)))
        q_j, _, i_j = _jax_solve(js, level, w)
        q_t, _, i_t = ts.solve_fwd(level, torch.from_numpy(w))
        assert q_t.dtype == F64 and bool(i_t.converged.all())
        assert abs(i_t.iterations - int(i_j.iterations)) <= max(1, 0.1 * int(i_j.iterations))
        assert rel_err(q_t, q_j) < 1e-6


@pytest.mark.parametrize("kw,msg", [(dict(spatial_shards=2), "item 14")])
def test_unported_kinv_options_raise(kw, msg):
    hier = _hierarchy(2)
    cfg = ProblemConfig(refinements=1)
    cfg.darcy_solver.name = "cg-schur-coefmg"
    for k, v in kw.items():
        setattr(cfg.darcy_solver, k, v)
    with pytest.raises(NotImplementedError, match=msg):
        DarcySolver(hier, port_config(cfg), F64, device=CPU,
                    kinv_ref=np.ones((hier.levels[0].n_s, 3)))


# -- every Darcy solver under a kinv_ref --------------------------------------------

KINV_SOLVERS = {
    "static-mg": dict(name="cg-schur"),
    "static-mg-local": dict(name="cg-schur", local_schur_scaling=True),
    "static-mg-lines": dict(name="cg-schur", mg_line_smoother=True),
    "static-mg-jacobi-coarse": dict(name="cg-schur", mg_coarse_sweeps=4, local_schur_scaling=True),
    "diag": dict(name="cg-schur-diag"),
    "exact": dict(name="cg-schur-exact"),
    "exact-local": dict(name="cg-schur-exact", local_schur_scaling=True),
    "gather": dict(name="cg-schur-coefmg", coefmg_impl="gather"),
    "gather-cheby-cycles2": dict(name="cg-schur-coefmg", coefmg_impl="gather",
                                 coefmg_cheby_order=3, coefmg_cheby_lo=0.1, coefmg_cycles=2),
    "minres": dict(name="minres-bj"),
}


def _kinv_solvers(coarse_operators="galerkin", **solver_kw):
    """_spe10_solvers at rtol 1e-10 with the square root of the synthetic
    kinv_ref: at the full contrast the flux QoI carries ~1e3 x the relative
    residual, and the diagonal and S(1) preconditioners need thousands of
    iterations; at half the log-contrast rtol 1e-10 pins Q to 1e-8 and
    every solver converges in hundreds. The static MG gets a small dense
    cutoff, so it has levels here."""
    rtol = solver_kw.pop("relative_tolerance", 1e-10)
    return _spe10_solvers(coarse_operators, kinv_power=0.5, rtol=rtol, max_iters=4000,
                          mg_cutoff=40, **solver_kw)


@pytest.mark.parametrize("coarse_operators", ["galerkin", "rediscretize"])
@pytest.mark.parametrize("variant", sorted(KINV_SOLVERS))
def test_kinv_solver_matches_jax(variant, coarse_operators):
    """Every solver name under a kinv_ref, Galerkin and rediscretized coarse
    operators: Q and pressure to 1e-8 at rtol 1e-10 in float64, iteration
    counts within 2, or within 2 % of the count where a weak preconditioner
    takes hundreds of iterations (CG amplifies the packages' different
    rounding with its length, which moves the stopping iteration)."""
    hier, js, ts = _kinv_solvers(coarse_operators, **KINV_SOLVERS[variant])
    rng = np.random.default_rng(12)
    for level in (0, 1):
        w = np.exp(0.5 * rng.normal(size=(2, hier.levels[level].n_s)))
        ref = _jax_solve(js, level, w, return_pressure=True)
        got = ts.solve_fwd(level, torch.from_numpy(w), return_pressure=True)
        assert bool(got[2].converged.all()) and bool(np.asarray(ref[2].converged).all())
        slack = max(2, int(ref[2].iterations) // 50)
        assert abs(got[2].iterations - int(ref[2].iterations)) <= slack
        assert rel_err(got[0], ref[0]) < 1e-8
        assert rel_err(got[3], ref[3]) < 1e-8


@pytest.mark.parametrize("variant", ["static-mg-lines", "diag", "exact-local", "gather", "minres"])
def test_kinv_level_state_equals_converted_jax(variant):
    """The new DarcyLevel state (static MG with its line tables and damping
    factors, diag(S_bar), kinv scalings, gather coefMG tables, the masked
    mass ELL) is the reference's, array for array."""
    hier, js, ts = _kinv_solvers(**KINV_SOLVERS[variant])
    for l in range(3):
        a, b = ts.levels[l], darcy_level_from_jax(js.levels[l], device=CPU)
        sa, sb = a.state_dict(), b.state_dict()
        # The reference also builds the static MG under minres-bj, which
        # never applies it; the port builds it for "cg-schur" alone.
        extra = set(sb) - set(sa)
        assert set(sa) <= set(sb) and all(k.startswith("schur_mg.") for k in extra), extra
        assert not extra or variant == "minres"
        for k in sa:
            if k.startswith(("schur.", "rhs", "obs_func")):  # held elsewhere, to rounding
                assert rel_err(sa[k], sb[k]) < 1e-12, (l, k)
            else:
                assert torch.equal(sa[k], sb[k]), (l, k)
        assert a.kinv_logmean == b.kinv_logmean
        if a.schur_mg is not None:
            for mg_a, mg_b in zip(a.schur_mg.levels, b.schur_mg.levels):
                for ln_a, ln_b in zip(mg_a.line or (), mg_b.line or ()):
                    assert ln_a.omega == ln_b.omega
        assert ts.nnz(l) == js.nnz(l)
        for x, y in zip(ts.level_blocks(l), js.level_blocks(l)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ts.sbar_diag_np(l), js.sbar_diag_np(l))
    if variant == "static-mg-lines":
        assert ts.levels[0].schur_mg.levels[0].line is not None


def test_cg_schur_family_agrees_with_minres_under_kinv():
    """The saddle-system oracle against the Schur-CG solvers on the SPE10
    class: the same Q whatever the preconditioner."""
    rng = np.random.default_rng(13)
    hier = _hierarchy()
    w = torch.from_numpy(np.exp(0.5 * rng.normal(size=(2, hier.levels[1].n_s))))
    qs = {}
    for variant in ("minres", "static-mg", "diag", "exact", "gather"):
        _, _, ts = _kinv_solvers(**KINV_SOLVERS[variant])
        q, _, info = ts.solve_fwd(1, w)
        assert bool(info.converged.all()), variant
        qs[variant] = q
    for variant, q in qs.items():
        assert rel_err(q, qs["minres"]) < 1e-7, variant


def test_gather_coefmg_matches_structured():
    """tests/test_darcy.py's oracle on the port: the gather and the slicing
    coefMG precondition the same solve to the same Q in the same count."""
    out = {}
    for impl in ("auto", "gather"):
        hier, _, ts = _kinv_solvers(name="cg-schur-coefmg", coefmg_impl=impl)
        w = torch.from_numpy(np.exp(0.5 * np.random.default_rng(14).normal(
            size=(2, hier.levels[0].n_s))))
        out[impl] = ts.solve_fwd(0, w)
    np.testing.assert_allclose(to_np(out["auto"][0]), to_np(out["gather"][0]), rtol=1e-8)
    assert abs(out["auto"][2].iterations - out["gather"][2].iterations) <= 2


def test_gather_coefmg_bfloat16_state_matches_jax():
    """coefmg_prec_dtype=bfloat16 with the gather form: dinvs and idiags in
    bf16 (not the index tables), the CG in float64."""
    hier, js, ts = _kinv_solvers(name="cg-schur-coefmg", coefmg_impl="gather",
                                 coefmg_prec_dtype="bfloat16", relative_tolerance=1e-8)
    w = np.exp(0.5 * np.random.default_rng(15).normal(size=(2, hier.levels[0].n_s)))
    q_j, _, i_j = _jax_solve(js, 0, w)
    q_t, _, i_t = ts.solve_fwd(0, torch.from_numpy(w))
    assert q_t.dtype == F64 and bool(i_t.converged.all())
    assert abs(i_t.iterations - int(i_j.iterations)) <= max(1, 0.1 * int(i_j.iterations))
    assert rel_err(q_t, q_j) < 1e-6


# -- the stacked adjoint on the SPE10 class -----------------------------------------

STACKED = {
    "coefmg-cheby": dict(name="cg-schur-coefmg", coefmg_cheby_order=3, coefmg_cheby_lo=0.1),
    "coefmg-lines-bf16": dict(name="cg-schur-coefmg", coefmg_line_axes="auto",
                              coefmg_prec_dtype="bfloat16"),
    "gather": dict(name="cg-schur-coefmg", coefmg_impl="gather"),
    "static-mg-lines": dict(name="cg-schur", mg_line_smoother=True, local_schur_scaling=True),
    "diag": dict(name="cg-schur-diag"),
    "exact": dict(name="cg-schur-exact"),
}


@pytest.mark.parametrize("variant", sorted(STACKED))
def test_adjoint_stacked_matches_sequential_and_jax(variant):
    """tests/test_darcy.py:428 on the port, under every preconditioner:
    the stacked solve reproduces the sequential one (Q, pressure, adjoint,
    honest flags, iterations as operator applications) and the JAX
    package's stacked solve."""
    kw = dict(adjoint_qoi=True, **STACKED[variant])
    hier, js, stk = _kinv_solvers(adjoint_stacked=True, **kw)
    _, _, seq = _kinv_solvers(adjoint_stacked=False, **kw)
    bf16 = "bf16" in variant
    w = np.exp(0.5 * np.random.default_rng(16).normal(size=(2, hier.levels[0].n_s)))
    a = seq.solve_fwd(0, torch.from_numpy(w), return_pressure=True, return_adjoint=True)
    b = stk.solve_fwd(0, torch.from_numpy(w), return_pressure=True, return_adjoint=True)
    assert bool(a[2].converged.all()) and bool(b[2].converged.all())
    np.testing.assert_allclose(to_np(b[0]), to_np(a[0]), rtol=1e-8)
    for k in (3, 4):
        np.testing.assert_allclose(to_np(b[k]), to_np(a[k]), rtol=0,
                                   atol=1e-7 * float(a[k].abs().max()))
    assert a[2].iterations // 2 <= b[2].iterations <= 2 * a[2].iterations
    ref = _jax_solve(js, 0, w, return_pressure=True, return_adjoint=True)
    assert abs(b[2].iterations - int(ref[2].iterations)) <= max(
        2, (0.1 if bf16 else 0.02) * int(ref[2].iterations))
    assert rel_err(b[0], ref[0]) < 1e-8
    assert rel_err(b[3], ref[3]) < 1e-7 and rel_err(b[4], ref[4]) < 1e-7
    # Warm-start threading: restarting from its own converged (p, lam)
    # exits (nearly) at once at the same Q.
    q_w, _, info_w, _, _ = stk.solve_fwd_x0(0, torch.from_numpy(w), b[3], lam0=b[4],
                                            return_pressure=True, return_adjoint=True)
    assert info_w.iterations <= 4
    np.testing.assert_allclose(to_np(q_w), to_np(b[0]), rtol=1e-8)


def test_stacked_pair_with_meanfield_through_the_manager():
    """MLMCManager's adjoint pair and the mean-field start under
    adjoint_stacked (tests/test_darcy.py:491-558 on the port): the pair
    agrees with the sequential one, the mean-field start saves iterations,
    and a manager round gives the same moments either way."""
    kw = dict(name="cg-schur-coefmg", adjoint_qoi=True, coefmg_cheby_order=3,
              coefmg_cheby_lo=0.1, relative_tolerance=1e-8)
    hier, _, stk = _kinv_solvers(adjoint_stacked=True, meanfield_x0=True, **kw)
    _, _, seq = _kinv_solvers(adjoint_stacked=False, meanfield_x0=True, **kw)
    _, _, cold = _kinv_solvers(adjoint_stacked=True, meanfield_x0=False, **kw)
    rng = np.random.default_rng(17)
    w_f = torch.from_numpy(np.exp(0.5 * rng.normal(size=(2, hier.levels[0].n_s))))
    w_c = torch.from_numpy(np.exp(0.5 * rng.normal(size=(2, hier.levels[1].n_s))))
    a, b = seq.solve_fwd_pair(0, w_f, w_c), stk.solve_fwd_pair(0, w_f, w_c)
    assert bool(b[2].converged.all()) and bool(b[3].converged.all())
    np.testing.assert_allclose(to_np(b[0]), to_np(a[0]), rtol=1e-6)
    np.testing.assert_allclose(to_np(b[1]), to_np(a[1]), rtol=1e-6)
    assert set(stk._mf_cache) == {1} and stk._mf_cache[1][1] is not None
    q_m, _, info_m = stk.solve_fwd(1, w_c)
    q_c, _, info_c = cold.solve_fwd(1, w_c)
    np.testing.assert_allclose(to_np(q_m), to_np(q_c), rtol=1e-5)
    assert info_m.iterations < info_c.iterations
    ests = []
    for solver in (seq, stk):
        cfg = port_config(ProblemConfig(refinements=2, dtype="float64", batch_size=4, seed=0,
                                        mse=1e10, correlation_length=100.0,
                                        output_filename="", cost_model="dofs"))
        cfg.darcy_solver = solver.solver_cfg
        prob = tproblems.build_problem(
            dataclasses.replace(cfg, mesh="box", ncells=(3, 3, 2), lengths=(60.0, 50.0, 14.0)),
            kinv_ref=tspe10.load_spe10_kinv(None, ncells=(12, 12, 8)), device=CPU)
        mgr = MLMCManager(prob.solver, prob.sampler, prob.config)
        mgr.init_run([4, 4, 4])
        ests.append(mgr.estimate)
    assert abs(ests[0] - ests[1]) < 1e-5 * abs(ests[0])


# -- the fixed-seed scaled SPE10 MLMC anchor ---------------------------------------


def test_spe10_scaled_anchor_on_the_port():
    """tests/test_spe10_anchor.py::test_spe10_scaled_anchor on the port: the
    same stream and deep f64 solves reproduce the JAX package's pins."""
    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg = ProblemConfig(mesh="box", ncells=tuple(g // 4 for g in grid), lengths=lengths,
                        refinements=2, correlation_length=100.0, dtype="float64", mse=1e10,
                        initial_samples=32, batch_size=16, seed=0, output_filename="",
                        cost_model="dofs")
    cfg.normalize_marginals = True
    cfg.darcy_solver.name = "cg-schur-coefmg"
    cfg.darcy_solver.relative_tolerance = 1e-8
    cfg.darcy_solver.max_iterations = 2000
    cfg = port_config(cfg)
    prob = tproblems.build_problem(cfg, kinv_ref=tspe10.load_spe10_kinv(None, ncells=grid),
                                   device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    mgr.init_run([32, 32, 32])
    assert [prob.solver.num_dofs(l) for l in range(3)] == [17280, 2272, 312]
    assert abs(mgr.estimate - 361.882) < 0.5, mgr.estimate
    np.testing.assert_allclose(mgr.eQ, [330.433, 308.151, 298.182], rtol=2e-3)
    assert mgr.consistency.max() < 0.1
    assert mgr.varY[0] < mgr.varY[1] < mgr.varY[2]
