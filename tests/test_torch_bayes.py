"""BayesianInverseProblem and the ratio / splitting managers of the port,
held against the JAX package on the CPU in float64 from the same inputs:
observation functionals, G, likelihoods, R and the generated observation
data to 1e-8 on a log-std-0.5 field (CG amplifies the two packages'
rounding on rougher fields, see tests/test_torch_darcy.py), per-batch
r, rc, z, zc of the managers' level steps to 1e-6, the 20 moment sums and
both estimates; the closed-form cases and the single-level anchor of
tests/test_bayes.py; and the scaled SPE10 ratio and splitting anchors of
tests/test_spe10_anchor.py on the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.uq import BayesianInverseProblem as JaxBIP
from parelagmc_tpu.uq import BayesRatioManager as JaxRatioManager
from parelagmc_tpu.uq import ratio_managers as jrm
from parelagmc_tpu.utils.timing import TimeManager as JaxTimeManager
from parelagmc_tpu_torch.convert import bayes_obs_from_jax
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import (
    BayesianInverseProblem,
    BayesRatioManager,
    SLBayesRatioManager,
)
from parelagmc_tpu_torch.uq import ratio_managers as trm
from parelagmc_tpu_torch.utils.timing import TimeManager

F64 = torch.float64


def key_data(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def make_config(tmp_path, nlevels=2, m=0, mse=5e-3, **kw):
    """The configuration of tests/test_bayes.py: a 2^3 box of side 2 as the
    coarsest mesh."""
    return ProblemConfig(
        ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=nlevels - 1, dtype="float64",
        batch_size=16, initial_samples=16, mse=mse, bayes_num_obs=m,
        bayes_obs_coords=(0.5, 0.5, 0.5, 1.5, 1.5, 1.5)[: 3 * max(m, 1)], bayes_eps=0.45,
        bayes_ref_data_file=str(tmp_path / "ref_obs.dat"),
        output_filename=str(tmp_path / "ratio.dat"), **kw)


def port_problem(cfg):
    tcfg = port_config(cfg)
    prob = build_problem(tcfg, device=CPU)
    return prob, BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype)


def jax_problem(cfg):
    prob = jax_build_problem(cfg)
    return prob, JaxBIP(prob.solver, prob.sampler, prob.config, prob.dtype)


# -- closed forms (tests/test_bayes.py:39-73) ---------------------------------------


def test_observable_p_int_deterministic(tmp_path):
    # m = 0: G = int p / |D|; for k = 1 on the side-2 cube p(z) = z/2.
    prob, bip = port_problem(make_config(tmp_path, nlevels=1))
    w = torch.ones(1, prob.hierarchy.levels[0].n_s, dtype=F64)
    G, Q, cost = bip.compute_G(0, w)
    np.testing.assert_allclose(to_np(G), 0.5, rtol=1e-8)
    np.testing.assert_allclose(to_np(Q), 2.0, rtol=1e-8)
    assert cost == prob.solver.num_dofs(0) and bip.size_obs_data == 1


def test_observable_pointwise(tmp_path):
    prob, bip = port_problem(make_config(tmp_path, nlevels=1, m=2))
    w = torch.ones(1, prob.hierarchy.levels[0].n_s, dtype=F64)
    G, _, _ = bip.compute_G(0, w)
    assert tuple(G.shape) == (1, 2) and bip.size_obs_data == 2
    np.testing.assert_allclose(to_np(G)[0], [0.25, 0.75], rtol=1e-8)
    with pytest.raises(ValueError, match="no cells within eps"):
        port_problem(dataclasses.replace(make_config(tmp_path, nlevels=1, m=2), bayes_eps=1e-3,
                                         bayes_obs_coords=(0.9,) * 6))


def test_likelihood_and_R(tmp_path):
    cfg = make_config(tmp_path, nlevels=2)
    prob, bip = port_problem(cfg)
    bip.set_observational_data([0.5])
    w = torch.ones(2, prob.hierarchy.levels[0].n_s, dtype=F64)
    like, _ = bip.likelihood(0, w)
    np.testing.assert_allclose(to_np(like), 1.0, rtol=1e-8)  # zero misfit
    R, _ = bip.compute_R(0, w)
    np.testing.assert_allclose(to_np(R), 2.0, rtol=1e-7)
    bip.set_observational_data([0.7])
    like2, _ = bip.likelihood(0, w)
    np.testing.assert_allclose(to_np(like2), np.exp(-0.04 / (2 * cfg.bayes_noise)), rtol=1e-6)
    with pytest.raises(ValueError):
        bip.set_observational_data([0.1, 0.2])


def test_generate_and_reload_obs_data(tmp_path):
    cfg = make_config(tmp_path, nlevels=2)
    _, bip = port_problem(cfg)
    y = bip.generate_observational_data()
    assert y.shape == (1,) and y.dtype == np.float64
    _, bip2 = port_problem(dataclasses.replace(cfg, bayes_generate_ref_data=False))
    np.testing.assert_allclose(bip2.generate_observational_data(), y)
    np.testing.assert_allclose(to_np(bip2.G_obs), y)


# -- parity with the JAX package -----------------------------------------------------


@pytest.mark.parametrize("m,adjoint", [(0, False), (2, False), (2, True)])
def test_bayes_maps_match_jax(tmp_path, m, adjoint):
    """g_obs per level, compute_G, likelihood_and_Q, compute_R and the
    generated data. With adjoint_qoi (rtol 1e-4, the production pairing) Q
    carries the adjoint correction and G is read off the primal pressure
    in both packages."""
    cfg = make_config(tmp_path, nlevels=2, m=m, variance=0.25, seed=3)
    cfg.darcy_solver.relative_tolerance = 1e-4 if adjoint else 1e-12
    cfg.darcy_solver.adjoint_qoi = adjoint
    cfg.bayes_ref_data_file = ""
    jprob, jbip = jax_problem(cfg)
    tprob, tbip = port_problem(cfg)
    g_ref, _ = bayes_obs_from_jax(jbip, F64, CPU)
    for level in range(2):
        assert tuple(tbip.g_obs[level].shape) == (max(m, 1), tprob.hierarchy.levels[level].n_s)
        assert rel_err(tbip.g_obs[level], g_ref[level]) < 1e-14
        np.testing.assert_allclose(to_np(tbip.g_obs[level]).sum(axis=1), 1.0, rtol=1e-13)
    y_ref = jbip.generate_observational_data()
    y = tbip.generate_observational_data()
    tol = 1e-5 if adjoint else 1e-8  # the primal pressure is only rtol-converged
    np.testing.assert_allclose(y, y_ref, rtol=tol)
    tbip.set_observational_data(y_ref)
    rng = np.random.default_rng(m)
    for level in range(2):
        xi = 0.5 * rng.normal(size=(3, tprob.sampler.sample_size(level)))
        w_ref = jprob.sampler.eval(level, jnp.asarray(xi))
        w = tprob.sampler.eval(level, torch.from_numpy(xi))
        G_ref, Q_ref, _ = jax.jit(lambda w: jbip.compute_G(level, w))(w_ref)
        G, Q, _ = tbip.compute_G(level, w)
        assert rel_err(G, G_ref) < tol and rel_err(Q, Q_ref) < tol
        like_ref, Q_ref, _ = jax.jit(lambda w: jbip.likelihood_and_Q(level, w))(w_ref)
        like, Q, _ = tbip.likelihood_and_Q(level, w)
        assert rel_err(like, like_ref) < tol and rel_err(Q, Q_ref) < tol
        assert 0.0 < float(like.min()) and float(like.max()) <= 1.0
        R_ref, _ = jax.jit(lambda w: jbip.compute_R(level, w))(w_ref)
        R, _ = tbip.compute_R(level, w)
        assert rel_err(R, R_ref) < tol and rel_err(R, Q * like) < 1e-14
        assert rel_err(tbip.likelihood(level, w)[0], like) < 1e-14
        if adjoint:
            # Q differs from the plain functional by the adjoint correction.
            _, _, _, p = tprob.solver.solve_fwd(level, w, return_pressure=True)
            assert rel_err(torch.matmul(p, tbip.g_obs[level].T), G) < 1e-14


@pytest.mark.parametrize("split_programs", [False, True])
def test_ratio_steps_and_sums_match_jax(tmp_path, split_programs):
    """Per batch r, rc, z, zc of the coarsest and the coupled step against
    the JAX step on the same key (1e-6), then the 20 sums after init_run
    and both estimators' values from them. split_pair_programs runs the
    composed step in the port and draws the same stream."""
    JaxTimeManager.reset()
    TimeManager.reset()
    cfg = make_config(tmp_path, nlevels=2, seed=13, cost_model="dofs", variance=0.25,
                      split_pair_programs=split_programs, solve_segments=2)
    cfg.darcy_solver.relative_tolerance = 1e-10
    cfg.output_filename = ""
    _, jbip = jax_problem(cfg)
    _, tbip = port_problem(cfg)
    jbip.set_observational_data([0.55])
    tbip.set_observational_data([0.55])
    jmgr = JaxRatioManager(jbip, cfg)
    mgr = BayesRatioManager(tbip, port_config(cfg))
    assert mgr.solve_budget == (2 * cfg.darcy_solver.max_iterations if split_programs else None)
    for level in (1, 0):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 101), level), 5)
        want = [np.asarray(x) for x in jmgr._step(level)(key)]
        got = [to_np(x) for x in mgr._step(level)(key_data(key))]
        for name, a, b in zip(("r", "rc", "z", "zc"), got, want):
            assert a.shape == b.shape == (16,)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=f"{name} L{level}")
        assert (got[1] == 0).all() == (level == 1)
    jmgr.init_run([16, 32])
    mgr.init_run([16, 32])
    np.testing.assert_array_equal(mgr.level_nsamples, [16, 32])
    np.testing.assert_allclose(mgr.sums, jmgr.sums, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(mgr.estimate, jmgr.estimate, rtol=1e-7)
    np.testing.assert_allclose(mgr.E[:, trm.YRATIO].sum(), jmgr.E[:, jrm.YRATIO].sum(), rtol=1e-7)
    for f in ("varYR", "varYZ", "varYRatio", "cost", "level_nsamples_missing"):
        np.testing.assert_allclose(getattr(mgr, f), getattr(jmgr, f), rtol=1e-5, err_msg=f)
    assert mgr._counter == jmgr._counter == 3
    split = BayesRatioManager(tbip, port_config(cfg), splitting=True)
    split.sums, split.level_nsamples = mgr.sums.copy(), mgr.level_nsamples.copy()
    split.compute_nsamples_mse()
    assert split.estimate == pytest.approx(float(mgr.E[:, trm.YRATIO].sum()))
    assert "ML_BayesRatio_Splitting_Manager" in split.show_me()
    assert "Ratio Estimate" in mgr.show_me()


@pytest.mark.parametrize("splitting", [False, True])
def test_ml_ratio_manager_runs(tmp_path, splitting):
    TimeManager.reset()
    cfg = make_config(tmp_path, nlevels=2, mse=2e-3)
    _, bip = port_problem(cfg)
    bip.set_observational_data([0.55])
    mgr = BayesRatioManager(bip, port_config(cfg), splitting=splitting)
    est = mgr.run()
    assert mgr.ml_estimator_variance <= cfg.mse_splitting_ratio * mgr.eps2
    assert 1.0 < est < 5.0
    assert ("Splitting" if splitting else "Ratio") + " Estimate" in mgr.show_me()
    mgr.close()
    log = (tmp_path / "ratio.dat").read_text().splitlines()
    assert len(log) == 1 + int(mgr.level_nsamples.sum()) and log[0].split()[0] == "%level"


def test_sl_ratio_manager(tmp_path):
    TimeManager.reset()
    cfg = make_config(tmp_path, nlevels=1, mse=5e-3)
    _, bip = port_problem(cfg)
    bip.set_observational_data([0.55])
    mgr = SLBayesRatioManager(bip, port_config(cfg))
    est = mgr.run()
    np.testing.assert_allclose(est, 1.98477, rtol=0.05)  # tests/test_bayes.py:111
    assert "SL_BayesRatio_Manager" in mgr.show_me() and mgr.nlevels == 1
    mgr.close()


def test_ratio_manager_generates_missing_data_and_guards_zero_likelihoods(tmp_path):
    TimeManager.reset()
    cfg = make_config(tmp_path, nlevels=2, mse=1e10, cost_model="dofs")
    cfg.output_filename = ""
    _, bip = port_problem(cfg)
    mgr = BayesRatioManager(bip, port_config(cfg))
    assert bip.G_obs is None
    mgr.init_run([4, 0])  # level 1 skipped
    assert bip.G_obs is not None and list(mgr.level_nsamples) == [16, 0]
    # Data far from every sample: z underflows to 0 and the ratios stay finite.
    bip.set_observational_data([1e3])
    mgr2 = BayesRatioManager(bip, port_config(cfg), nlevels=1)
    mgr2.init_run([16])
    assert mgr2.E[0, trm.Z] == 0.0 and mgr2.E[0, trm.RATIO] == 0.0
    assert mgr2.estimate == np.inf and np.isfinite(mgr2.sums).all()


def test_ratio_manager_refuses_sample_sharding(tmp_path):
    """Two sample shards on the CPU's one visible device raise ValueError,
    the reference's config rule (tests/test_torch_sharding.py runs the
    sharded ratio managers)."""
    cfg = make_config(tmp_path, nlevels=1)
    _, bip = port_problem(cfg)
    sharded = port_config(dataclasses.replace(cfg, sample_shards=2))
    with pytest.raises(ValueError, match="sample_shards=2 but only 1 device"):
        BayesRatioManager(bip, sharded)
    with pytest.raises(ValueError, match="batch_size_per_level"):
        BayesRatioManager(bip, port_config(dataclasses.replace(cfg, batch_size_per_level=[4, 4])))


# -- the scaled SPE10 anchors (tests/test_spe10_anchor.py:59-105) on the port -----------

OBS_COORDS = (300.0, 550.0, 85.0, 600.0, 1100.0, 85.0, 900.0, 1650.0, 85.0)


def spe10_ratio_problem(rtol=None, solver="cg-schur-coefmg"):
    """examples/spe10_ratio_mlmc.py --grid 16,32,8 --refinements 1 --samples 8
    --batch 8 --dtype float64. That run takes the default solver,
    "cg-schur" (under a kinv_ref: the static Schur multigrid), at tolerance
    1e-6 and 500 iterations, where its solves stop short of convergence, so
    the pins depend on the preconditioner: `solver` picks it."""
    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    eps = max(30.0, 0.75 * max(L / n for L, n in zip(lengths, grid)))
    cfg = port_config(ProblemConfig(
        mesh="box", ncells=tuple(g // 2 for g in grid), lengths=lengths, refinements=1,
        correlation_length=100.0, mse=1e10, initial_samples=8, batch_size=8,
        normalize_marginals=True, axis_order="auto", dtype="float64", bayes_num_obs=3,
        bayes_obs_coords=OBS_COORDS, bayes_eps=eps, bayes_generate_ref_data=True,
        bayes_ref_data_file="", output_filename=""))
    cfg.darcy_solver.name = solver
    if rtol is not None:
        cfg.darcy_solver.relative_tolerance = rtol
        cfg.darcy_solver.max_iterations = 2000
    prob = build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=CPU)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype)
    bip.generate_observational_data()
    return prob, bip


@pytest.mark.parametrize("splitting,pin", [(False, 354.436), (True, 350.767)])
def test_spe10_scaled_ratio_anchors(splitting, pin):
    TimeManager.reset()
    prob, bip = spe10_ratio_problem()
    assert prob.hierarchy.levels[0].mesh.shape == (32, 16, 8)  # axis_order auto
    # The obs coordinates moved with the axes: y first.
    assert prob.config.bayes_obs_coords[:3] == (550.0, 300.0, 85.0)
    mgr = BayesRatioManager(bip, prob.config, splitting=splitting)
    mgr.init_run([8, 8])
    np.testing.assert_allclose(mgr.estimate, pin, rtol=2e-3)
    assert np.all(mgr.level_nsamples == 8)
    # Likelihoods bounded away from 0: a broken observation pipeline
    # collapses Z and blows the ratio up.
    assert mgr.E[:, trm.Z].min() > 0.01


@pytest.mark.parametrize("splitting,pin", [(False, 354.436), (True, 350.767)])
def test_spe10_scaled_ratio_anchors_on_cg_schur(splitting, pin):
    """The pins were taken on "cg-schur": with the static Schur multigrid
    the port reproduces them at the reference's own tolerance."""
    TimeManager.reset()
    prob, bip = spe10_ratio_problem(solver="cg-schur")
    assert prob.solver.levels[0].schur_mg is not None
    mgr = BayesRatioManager(bip, prob.config, splitting=splitting)
    mgr.init_run([8, 8])
    np.testing.assert_allclose(mgr.estimate, pin, rtol=1e-3)
    assert np.all(mgr.level_nsamples == 8) and mgr.E[:, trm.Z].min() > 0.01


def test_spe10_scaled_ratio_anchor_deep_solves():
    """With deep solves the stream's estimate no longer depends on the
    preconditioner: the JAX package's own run of this configuration at rtol
    1e-10 (its static Schur multigrid) gives 354.78488 and observation data
    (0.31278864, 0.11646156, 0.59685582)."""
    TimeManager.reset()
    prob, bip = spe10_ratio_problem(rtol=1e-10)
    np.testing.assert_allclose(to_np(bip.G_obs), [0.31278864, 0.11646156, 0.59685582], rtol=2e-6)
    mgr = BayesRatioManager(bip, prob.config)
    mgr.init_run([8, 8])
    np.testing.assert_allclose(mgr.estimate, 354.78488, rtol=1e-6)
