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


@pytest.mark.parametrize("options", [dict(spatial_shards=2)])
def test_not_ported_solver_options_raise(options):
    hier, _ = _hierarchies((2, 2, 2), 1)
    cfg = ProblemConfig(refinements=0)
    for field, value in options.items():
        setattr(cfg.darcy_solver, field, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DarcySolver(hier, port_config(cfg), F64, device=CPU)


def test_unknown_solver_name_is_refused():
    hier, _ = _hierarchies((2, 2, 2), 1)
    cfg = ProblemConfig(refinements=0)
    cfg.darcy_solver.name = "cg-mg"  # a sampler solver of the unstructured stack
    with pytest.raises(ValueError, match="darcy solver"):
        DarcySolver(hier, port_config(cfg), F64, device=CPU)


# -- the saddle-system solver (minres-bj) ------------------------------------------


def test_minres_level_build_equals_converted_jax():
    """Under minres-bj the level carries the masked mass ELL, its diagonal
    structure and the essential mask, equal to the reference's; the Schur-CG
    family carries neither ELL."""
    hier, cfg, js, ts = _solvers(name="minres-bj")
    for l in range(2):
        a, b = ts.levels[l], darcy_level_from_jax(js.levels[l], device=CPU)
        _levels_equal(a, b)
        assert torch.equal(a.ess, b.ess)
        for name in ("cols", "mvals", "cells"):
            assert torch.equal(getattr(a.m_op, name), getattr(b.m_op, name)), name
        assert torch.equal(a.m_diag.cells, b.m_diag.cells)
        assert torch.equal(a.m_diag.vals, b.m_diag.vals)
        assert ts.nnz(l) == js.nnz(l)
    _, _, js2, ts2 = _solvers()
    assert ts2.levels[0].m_op is None and ts2.levels[0].m_diag is None
    assert [ts2.nnz(l) for l in range(2)] == [js2.nnz(l) for l in range(2)]


def test_saddle_operator_and_preconditioner_match_jax():
    hier, cfg, js, ts = _solvers(name="minres-bj")
    rng = np.random.default_rng(3)
    for level in (0, 1):
        L, Lj = ts.levels[level], js.levels[level]
        w = np.exp(rng.normal(size=(2, L.n_s)))
        x = rng.normal(size=(2, L.n_u + L.n_s))
        got = ts._apply_A(L, torch.from_numpy(w))(torch.from_numpy(x))
        assert rel_err(got, js._apply_A(Lj, jnp.asarray(w))(jnp.asarray(x))) < 1e-13
        got = ts._prec(L, torch.from_numpy(w))(torch.from_numpy(x))
        assert rel_err(got, js._prec(Lj, jnp.asarray(w))(jnp.asarray(x))) < 1e-12
        ess = to_np(L.ess)
        assert np.array_equal(to_np(ts._apply_A(L, torch.from_numpy(w))(torch.from_numpy(x)))
                              [:, :L.n_u][:, ess], x[:, :L.n_u][:, ess])  # identity rows


def test_minres_solve_fwd_matches_jax():
    """Q and pressure to 1e-8 at rtol 1e-10; MINRES counts within 2 (its
    two recurrences round apart more than CG's)."""
    hier, cfg, js, ts = _solvers(name="minres-bj", relative_tolerance=1e-10, max_iterations=800)
    rng = np.random.default_rng(5)
    for level in (0, 1):
        w = np.exp(0.5 * rng.normal(size=(3, hier.levels[level].n_s)))
        q_j, c_j, i_j, p_j = jax.jit(lambda w: js.solve_fwd(level, w, return_pressure=True))(
            jnp.asarray(w))
        q_t, c_t, i_t, p_t = ts.solve_fwd(level, torch.from_numpy(w), return_pressure=True)
        assert abs(i_t.iterations - int(i_j.iterations)) <= 2
        assert bool(i_t.converged.all()) and c_t == c_j
        assert rel_err(q_t, q_j) < 1e-8 and rel_err(p_t, p_j) < 1e-8


def test_cg_schur_matches_minres():
    """The independent oracle (tests/test_mass_solve.py:72 on the port):
    Schur CG and saddle MINRES agree, and CG needs far fewer iterations."""
    hier, _ = _hierarchies((4, 4, 4), 1)
    out = {}
    for name in ("cg-schur", "minres-bj"):
        cfg = ProblemConfig(refinements=0)
        cfg.darcy_solver.name = name
        cfg.darcy_solver.relative_tolerance = 1e-11
        out[name] = DarcySolver(hier, port_config(cfg), F64, device=CPU)
    w = torch.from_numpy(np.exp(np.random.default_rng(2).normal(size=(3, hier.levels[0].n_s))))
    Q1, c1, i1, p1 = out["cg-schur"].solve_fwd(0, w, return_pressure=True)
    Q2, c2, i2, p2 = out["minres-bj"].solve_fwd(0, w, return_pressure=True)
    np.testing.assert_allclose(to_np(Q1), to_np(Q2), rtol=1e-7)
    np.testing.assert_allclose(to_np(p1), to_np(p2), atol=1e-6)
    assert bool(i2.converged.all()) and i1.iterations < i2.iterations / 2


def test_minres_has_no_warm_start_and_no_adjoint():
    hier, cfg, js, ts = _solvers(name="minres-bj", relative_tolerance=1e-9, max_iterations=800)
    assert not ts.adjoint_pair_enabled(0)
    rng = np.random.default_rng(6)
    w = torch.from_numpy(np.exp(0.5 * rng.normal(size=(2, hier.levels[0].n_s))))
    w_c = torch.from_numpy(np.exp(0.5 * rng.normal(size=(2, hier.levels[1].n_s))))
    q, _, info, p = ts.solve_fwd(0, w, return_pressure=True)
    # Warm and same-level restarts fall back to the cold solve.
    qc, _, _, p_c = ts.solve_fwd(1, w_c, return_pressure=True)
    qw, _, info_w = ts.solve_fwd_warm(0, w, p_c)
    qx, _, info_x = ts.solve_fwd_x0(0, w, p)
    assert torch.equal(qw, q) and torch.equal(qx, q)
    assert info_w.iterations == info_x.iterations == info.iterations
    pair = ts.solve_fwd_pair(0, w, w_c)
    assert torch.equal(pair[0], q) and torch.equal(pair[1], qc)
    hier, cfg, js, ts = _solvers(name="minres-bj", adjoint_qoi=True)
    assert not ts.adjoint_pair_enabled(0)
    with pytest.raises(NotImplementedError, match="cg-schur solver family"):
        ts.solve_fwd(0, w)


# -- the stacked primal + adjoint solve --------------------------------------------


@pytest.mark.parametrize("local", [False, True])
def test_stacked_adjoint_matches_jax_and_sequential(local):
    """adjoint_stacked: one PCG over a right-hand-side axis at -2. Q,
    pressure and adjoint against the JAX package's stacked solve, the
    iteration report (2 x the loop's trips) equal, and against the port's
    sequential two-solve path."""
    kw = dict(adjoint_qoi=True, local_schur_scaling=local, relative_tolerance=1e-10)
    hier, cfg, js, ts = _solvers(adjoint_stacked=True, **kw)
    _, _, _, seq = _solvers(adjoint_stacked=False, **kw)
    rng = np.random.default_rng(9)
    for level in (0, 1):
        w = np.exp(0.5 * rng.normal(size=(3, hier.levels[level].n_s)))
        ref = jax.jit(lambda w: js.solve_fwd(level, w, return_pressure=True,
                                             return_adjoint=True))(jnp.asarray(w))
        got = ts.solve_fwd(level, torch.from_numpy(w), return_pressure=True, return_adjoint=True)
        assert abs(got[2].iterations - int(ref[2].iterations)) <= 2
        assert got[2].iterations % 2 == 0 and bool(got[2].converged.all())
        assert got[2].residual.shape == got[2].converged.shape == (3,)
        assert rel_err(got[0], ref[0]) < 1e-8
        assert rel_err(got[3], ref[3]) < 1e-8 and rel_err(got[4], ref[4]) < 1e-8
        two = seq.solve_fwd(level, torch.from_numpy(w), return_pressure=True, return_adjoint=True)
        assert rel_err(got[0], two[0]) < 1e-8
        assert rel_err(got[3], two[3]) < 1e-7 and rel_err(got[4], two[4]) < 1e-7
        assert two[2].iterations // 2 <= got[2].iterations <= 2 * two[2].iterations


def test_stacked_adjoint_pair_matches_sequential():
    """The MLMC pair under adjoint_stacked: the coarse pressure and adjoint
    warm-start the fine stacked solve."""
    kw = dict(adjoint_qoi=True, relative_tolerance=1e-10)
    hier, cfg, js, stk = _solvers(adjoint_stacked=True, **kw)
    _, _, _, seq = _solvers(adjoint_stacked=False, **kw)
    assert stk.adjoint_pair_enabled(0)
    rng = np.random.default_rng(10)
    w_f = torch.from_numpy(np.exp(0.5 * rng.normal(size=(3, hier.levels[0].n_s))))
    w_c = torch.from_numpy(np.exp(0.5 * rng.normal(size=(3, hier.levels[1].n_s))))
    a, b = seq.solve_fwd_pair(0, w_f, w_c), stk.solve_fwd_pair(0, w_f, w_c)
    assert rel_err(b[0], a[0]) < 1e-8 and rel_err(b[1], a[1]) < 1e-8
    assert bool(b[2].converged.all()) and bool(b[3].converged.all())
    ref = jax.jit(lambda x, y: js.solve_fwd_pair(0, x, y))(jnp.asarray(to_np(w_f)),
                                                           jnp.asarray(to_np(w_c)))
    assert rel_err(b[0], ref[0]) < 1e-8 and rel_err(b[1], ref[1]) < 1e-8
    for k in (2, 3):
        assert abs(b[k].iterations - int(ref[k].iterations)) <= 2
    # A solve restarted from its own converged iterates needs no more work.
    q, _, info, p, lam = stk.solve_fwd(0, w_f, return_pressure=True, return_adjoint=True)
    q2, _, info2 = stk.solve_fwd_x0(0, w_f, p, lam0=lam)
    assert info2.iterations <= 4 and rel_err(q2, q) < 1e-8
