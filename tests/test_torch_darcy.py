"""Batched PCG and the cg-schur Darcy solver of the port held against the
JAX package on the CPU in float64: equal iteration counts, Q to 1e-9
relative, and the fixed-seed per-level anchors of darcy_random_input.
(cg-schur-coefmg, kinv_ref, adjoint and meanfield: tests/test_torch_spe10.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy as jax_build_geometric_hierarchy
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops.solvers import pcg as jax_pcg
from parelagmc_tpu.physics import DarcySolver as JaxDarcySolver
from parelagmc_tpu_torch.convert import darcy_level_from_jax
from parelagmc_tpu_torch.fem import build_geometric_hierarchy
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.ops.solvers import pcg
from parelagmc_tpu_torch.physics import DarcySolver
from parelagmc_tpu_torch.problems import build_problem

F64 = torch.float64


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = Q @ np.diag(np.logspace(0, 1, n)) @ Q.T
    return 0.5 * (A + A.T), rng


@pytest.mark.parametrize(
    "restart_every,warm,want_r_true",
    [(0, False, False), (7, False, False), (5, True, True), (0, True, False)],
)
def test_pcg_matches_jax(restart_every, warm, want_r_true):
    n = 40
    A, rng = _spd(n, restart_every + 10 * warm)
    dinv = 1.0 / np.diag(A)
    b = rng.normal(size=(3, n))
    b[1] *= 1e-3  # rows converge at different iterations (masking)
    x0 = 1e-3 * rng.normal(size=(3, n)) if warm else None
    kw = dict(max_iters=200, rtol=1e-10, atol=1e-300, restart_every=restart_every,
              want_r_true=want_r_true)
    jA = jnp.asarray(A)
    ref = jax_pcg(lambda x: x @ jA, jnp.asarray(b), prec=lambda r: r * jnp.asarray(dinv),
                  x0=None if x0 is None else jnp.asarray(x0), **kw)
    tA = torch.from_numpy(A)
    got = pcg(lambda x: x @ tA, torch.from_numpy(b), prec=lambda r: r * torch.from_numpy(dinv),
              x0=None if x0 is None else torch.from_numpy(x0), **kw)
    assert got[1].iterations == int(ref[1].iterations)
    assert rel_err(got[0], ref[0]) < 1e-9
    np.testing.assert_array_equal(to_np(got[1].converged), np.asarray(ref[1].converged))
    # Final relative residuals sit near rtol, where only rounding separates them.
    np.testing.assert_allclose(to_np(got[1].residual), np.asarray(ref[1].residual),
                               rtol=0, atol=1e-13)
    if want_r_true:  # the true residual of the returned iterate
        r_true = torch.from_numpy(b) - got[0] @ tA
        assert torch.allclose(got[2], r_true, rtol=0, atol=1e-14)


def test_pcg_unconverged_rows_are_flagged():
    A, rng = _spd(30, 3)
    b = torch.from_numpy(rng.normal(size=(2, 30)))
    tA = torch.from_numpy(A)
    x, info = pcg(lambda x: x @ tA, b, max_iters=3, rtol=1e-12)
    assert info.iterations == 3 and not bool(info.converged.any())


def _hierarchies(ncells, nlevels):
    """(port, JAX) hierarchies of one box of side 2: each package builds
    its own."""
    args = (ncells, (2.0, 2.0, 2.0))
    return (build_geometric_hierarchy(make_box_mesh(*args), nlevels),
            jax_build_geometric_hierarchy(jax_make_box_mesh(*args), nlevels))


def _solvers(refinements=1, **solver_kw):
    hier, jhier = _hierarchies((4, 4, 4), refinements + 1)
    cfg = ProblemConfig(refinements=refinements)
    for k, v in solver_kw.items():
        setattr(cfg.darcy_solver, k, v)
    return (hier, cfg, JaxDarcySolver(jhier, cfg, jnp.float64),
            DarcySolver(hier, port_config(cfg), F64, device=CPU))


def _levels_equal(a, b):
    assert (a.n_u, a.n_s, a.shape, a.face_offsets) == (b.n_u, b.n_s, b.shape, b.face_offsets)
    for name in ("rhs", "obs_func"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for ma, mb in zip(a.b_masks, b.b_masks):
        assert torch.equal(ma, mb)
    for va, vb in zip(a.schur.V, b.schur.V):
        assert torch.equal(va, vb)
    assert torch.equal(a.schur.lam, b.schur.lam)
    for xa, xb in zip(a.mass_solver.axes, b.mass_solver.axes):
        for name in ("m_lo", "m_mid", "m_hi", "ess"):
            assert torch.equal(getattr(xa, name), getattr(xb, name)), name


@pytest.mark.parametrize("qoi", ["eff_perm", "p_int", "local_avg_p"])
def test_darcy_level_build_equals_converted_jax(qoi):
    hier, jhier = _hierarchies((4, 4, 4), 2)
    cfg = ProblemConfig(refinements=1, qoi=qoi)
    js = JaxDarcySolver(jhier, cfg, jnp.float64)
    ts = DarcySolver(hier, port_config(cfg), F64, device=CPU)
    for l in range(2):
        _levels_equal(ts.levels[l], darcy_level_from_jax(js.levels[l], device=CPU))
        assert ts.num_dofs(l) == js.num_dofs(l)


@pytest.mark.parametrize("local", [False, True])
def test_solve_fwd_matches_jax(local):
    # CG amplifies the two packages' different rounding (reduction order)
    # with its iteration count; a mild field (log-std 0.5) keeps the solves
    # short enough that iterates agree far below the 1e-9 tolerance.
    hier, cfg, js, ts = _solvers(local_schur_scaling=local, relative_tolerance=1e-10)
    rng = np.random.default_rng(7)
    for level in (0, 1):
        w = np.exp(0.5 * rng.normal(size=(3, hier.levels[level].n_s)))
        q_j, c_j, i_j, p_j = js.solve_fwd(level, jnp.asarray(w), return_pressure=True)
        q_t, c_t, i_t, p_t = ts.solve_fwd(level, torch.from_numpy(w), return_pressure=True)
        assert i_t.iterations == int(i_j.iterations)
        assert bool(i_t.converged.all()) and c_t == c_j
        assert rel_err(q_t, q_j) < 1e-9
        assert rel_err(p_t, p_j) < 1e-8


def test_solve_fwd_pair_matches_jax_and_runs_on_converted_levels():
    hier, cfg, js, ts = _solvers(relative_tolerance=1e-10)
    rng = np.random.default_rng(8)
    w_f = np.exp(0.5 * rng.normal(size=(4, hier.levels[0].n_s)))
    w_c = np.exp(0.5 * rng.normal(size=(4, hier.levels[1].n_s)))
    ref = js.solve_fwd_pair(0, jnp.asarray(w_f), jnp.asarray(w_c))
    got = ts.solve_fwd_pair(0, torch.from_numpy(w_f), torch.from_numpy(w_c))
    assert got[2].iterations == int(ref[2].iterations)
    assert got[3].iterations == int(ref[3].iterations)
    assert rel_err(got[0], ref[0]) < 1e-9 and rel_err(got[1], ref[1]) < 1e-9
    # Identical operators by construction: swap in the converted levels.
    ts.levels = torch.nn.ModuleList([darcy_level_from_jax(L, device=CPU) for L in js.levels])
    again = ts.solve_fwd_pair(0, torch.from_numpy(w_f), torch.from_numpy(w_c))
    assert rel_err(again[0], ref[0]) < 1e-9


def test_darcy_random_input_anchors():
    """examples/darcy_random_input.py on the port: the per-level anchors of
    tests/test_examples.py:47 (f64, seed 0, rtol 1e-4)."""
    cfg = ProblemConfig(refinements=2, dtype="float64", seed=0)
    prob = build_problem(port_config(cfg), device=CPU)
    key = PRNGKey(cfg.seed)
    golden = {0: 2.6480155, 1: 2.7483976, 2: 1.8151928}
    for level in range(3):
        xi = prob.sampler.sample(level, fold_in(key, level), 1)
        q, _, info = prob.solver.solve_fwd(level, prob.sampler.eval(level, xi))
        assert bool(info.converged.all())
        np.testing.assert_allclose(float(q[0]), golden[level], rtol=1e-4)
    assert [prob.solver.num_dofs(l) for l in range(3)] == [17152, 2240, 304]


def test_constant_coefficient_gives_unit_slab_flux():
    """k = 1: the effective permeability is 2 on every level (the
    darcy_test golden, tests/test_examples.py:17)."""
    hier, cfg, js, ts = _solvers(refinements=2)
    for level in range(3):
        q, _, info = ts.solve_fwd(level, torch.ones(1, hier.levels[level].n_s, dtype=F64))
        np.testing.assert_allclose(float(q[0]), 2.0, rtol=1e-5)


@pytest.mark.parametrize(
    "options",
    [dict(name="minres-bj"), dict(name="cg-schur-diag"),
     dict(name="cg-schur-coefmg", coefmg_impl="gather"),
     dict(adjoint_qoi=True, adjoint_stacked=True), dict(spatial_shards=2)],
)
def test_not_ported_solver_options_raise(options):
    hier, _ = _hierarchies((2, 2, 2), 1)
    cfg = ProblemConfig(refinements=0)
    for field, value in options.items():
        setattr(cfg.darcy_solver, field, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DarcySolver(hier, port_config(cfg), F64, device=CPU)
