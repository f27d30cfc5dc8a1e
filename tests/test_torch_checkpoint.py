"""Checkpoint and resume of the port's managers (MLMCManager and the ratio
managers): a resumed run continues the key counter and equals the
uninterrupted one to 1e-12; seed and estimator-kind mismatches raise. And
MCManager, the one-level special case, against the JAX package's MCManager
on one stream. Checkpoints cross the packages both ways: the JAX
package's load in the port and resume to its own resumed estimate, and
the port's in the JAX package. CPU, float64, the configurations of
tests/test_checkpoint.py and tests/test_bayes.py:151-196."""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.uq import BayesianInverseProblem as JaxBIP
from parelagmc_tpu.uq import BayesRatioManager as JaxRatioManager
from parelagmc_tpu.uq import MCManager as JaxMCManager
from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
from parelagmc_tpu.utils.timing import TimeManager as JaxTimeManager
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import (
    BayesianInverseProblem,
    BayesRatioManager,
    MCManager,
    MLMCManager,
)
from parelagmc_tpu_torch.utils.timing import SteadyCostLedger, TimeManager


def mlmc_manager(tmp_path, tag, **kw):
    args = dict(ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1, dtype="float64",
                mse=4e-3, batch_size=16, initial_samples=16,
                output_filename=str(tmp_path / f"{tag}.dat"), seed=7, cost_model="dofs")
    cfg = port_config(ProblemConfig(**{**args, **kw}))
    prob = build_problem(cfg, device=CPU)
    return MLMCManager(prob.solver, prob.sampler, cfg)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    TimeManager.reset()
    m1 = mlmc_manager(tmp_path, "full")
    est1 = m1.run()
    n1 = m1.level_nsamples.copy()
    assert m1._counter > 2  # the adaptive loop ran past the first round
    TimeManager.reset()
    m2 = mlmc_manager(tmp_path, "part1")
    m2.init_run(m2.init_nsamples)
    ckpt = str(tmp_path / "state.npz")
    m2.save_state(ckpt)
    m2.close()
    TimeManager.reset()
    m3 = mlmc_manager(tmp_path, "part2")
    est3 = m3.resume(ckpt)
    np.testing.assert_allclose(est3, est1, rtol=1e-12)
    np.testing.assert_array_equal(m3.level_nsamples, n1)
    assert m3._counter == m1._counter
    np.testing.assert_allclose(m3.sums, m1.sums, rtol=1e-12)
    np.testing.assert_allclose(m3.solver_iterations, m1.solver_iterations, rtol=1e-12)
    m1.close()
    m3.close()


def test_checkpoint_restores_walltime_costs(tmp_path):
    """Timers and the steady-cost ledger round-trip, so a resumed walltime
    run allocates from the same C_l."""
    TimeManager.reset()
    m = mlmc_manager(tmp_path, "w", cost_model="walltime")
    m.init_run([32, 32])
    ckpt = str(tmp_path / "w.npz")
    m.save_state(ckpt)
    cost, missing = m.cost.copy(), m.level_nsamples_missing.copy()
    ledger = m._cost_ledger.state()
    TimeManager.reset()
    m2 = mlmc_manager(tmp_path, "w2", cost_model="walltime")
    m2.load_state(ckpt)
    np.testing.assert_array_equal(m2.cost, cost)
    np.testing.assert_array_equal(m2.level_nsamples_missing, missing)
    for k, v in m2._cost_ledger.state().items():
        np.testing.assert_array_equal(v, ledger[k])
    assert not m2._cost_ledger.seen(0)  # this process has run nothing yet
    fresh = SteadyCostLedger(2)
    fresh.load({"sums": 0})  # a checkpoint without the ledger keeps zeros
    assert fresh.nsamples.sum() == 0
    m.close()
    m2.close()


def test_checkpoint_seed_mismatch(tmp_path):
    TimeManager.reset()
    m = mlmc_manager(tmp_path, "a")
    m.init_run([16, 16])
    ckpt = str(tmp_path / "s.npz")
    m.save_state(ckpt)
    m.config.seed = 8
    with pytest.raises(ValueError, match="seed"):
        m.load_state(ckpt)
    m.close()


def ratio_manager(tmp_path, splitting=False, **kw):
    cfg = port_config(ProblemConfig(
        ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1, dtype="float64",
        batch_size=16, initial_samples=16, mse=2e-3,
        bayes_ref_data_file=str(tmp_path / "ref_obs.dat"), output_filename="", **kw))
    prob = build_problem(cfg, device=CPU)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    return BayesRatioManager(bip, cfg, splitting=splitting)


@pytest.mark.parametrize("splitting", [False, True])
def test_ratio_checkpoint_resume_matches_uninterrupted(tmp_path, splitting):
    TimeManager.reset()
    obs = ratio_manager(tmp_path).problem.generate_observational_data()  # writes the file
    fresh = lambda: ratio_manager(tmp_path, splitting, cost_model="dofs",
                                  bayes_generate_ref_data=False)
    TimeManager.reset()
    m1 = fresh()
    est1 = m1.run()
    n1 = m1.level_nsamples.copy()
    assert m1._counter > 2
    TimeManager.reset()
    m2 = fresh()
    m2.init_run([m2.init_nsamples] * m2.nlevels)
    ckpt = str(tmp_path / "ratio_state.npz")
    m2.save_state(ckpt)
    # The checkpoint carries the observation data: the resuming problem
    # needs neither the file nor a new draw.
    (tmp_path / "ref_obs.dat").unlink()
    TimeManager.reset()
    m3 = fresh()
    est3 = m3.resume(ckpt)
    np.testing.assert_allclose(est3, est1, rtol=1e-12)
    np.testing.assert_array_equal(m3.level_nsamples, n1)
    np.testing.assert_allclose(m3.problem.G_obs.numpy(), obs, rtol=0, atol=0)
    assert m3._counter == m1._counter


def test_ratio_checkpoint_kind_and_seed_mismatch(tmp_path):
    TimeManager.reset()
    m = ratio_manager(tmp_path, splitting=True)
    m.init_run([4, 4])
    ckpt = str(tmp_path / "k.npz")
    m.save_state(ckpt)
    m2 = BayesRatioManager(m.problem, m.config, splitting=False)
    with pytest.raises(ValueError, match="splitting"):
        m2.load_state(ckpt)
    # An MLMCManager file is another estimator's too.
    mlmc = mlmc_manager(tmp_path, "m", seed=0)
    mlmc.init_run([16, 16])
    mlmc.save_state(str(tmp_path / "mlmc.npz"))
    mlmc.close()
    with pytest.raises(ValueError, match="splitting"):
        m.load_state(str(tmp_path / "mlmc.npz"))
    m.config.seed = 5
    with pytest.raises(ValueError, match="seed"):
        m.load_state(ckpt)


def test_mc_manager_matches_jax(tmp_path):
    """Single-level MC on the finest level: same stream, dofs cost model and
    deep solves, so N and the estimate agree with the JAX MCManager."""
    JaxTimeManager.reset()
    TimeManager.reset()
    cfg = ProblemConfig(ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1,
                        dtype="float64", mse=2e-3, batch_size=8, initial_samples=8, seed=3,
                        cost_model="dofs", output_filename="")
    cfg.darcy_solver.relative_tolerance = 1e-10
    jprob = jax_build_problem(cfg)
    jmgr = JaxMCManager(jprob.solver, jprob.sampler, cfg)
    ref = jmgr.run()
    tcfg = port_config(cfg)
    prob = build_problem(tcfg, device=CPU)
    mgr = MCManager(prob.solver, prob.sampler, tcfg)
    est = mgr.run()
    assert mgr.nlevels == 1 and mgr.expected_discretization_error2 == 0.0
    np.testing.assert_array_equal(mgr.level_nsamples, jmgr.level_nsamples)
    assert mgr.level_nsamples[0] > 8  # the adaptive loop added samples
    np.testing.assert_allclose(est, ref, rtol=1e-9)
    np.testing.assert_allclose(mgr.varY, jmgr.varY, rtol=1e-7)
    np.testing.assert_allclose(mgr.eQ, mgr.eY, rtol=0)  # Y == Q on one level
    assert "SLMC Manager" in mgr.show_me() and "MLMC Manager" not in mgr.show_me()
    assert torch.device(prob.device) == CPU


# -- checkpoints across the two packages -----------------------------------------


def _jax_and_port_mlmc(tmp_path, tag):
    cfg = ProblemConfig(ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1,
                        dtype="float64", mse=4e-4, batch_size=16, initial_samples=16, seed=7,
                        cost_model="dofs", variance=0.25,
                        output_filename=str(tmp_path / f"{tag}.dat"))
    cfg.darcy_solver.relative_tolerance = 1e-10
    jprob = jax_build_problem(cfg)
    tcfg = port_config(cfg)
    prob = build_problem(tcfg, device=CPU)
    return (lambda: JaxMLMCManager(jprob.solver, jprob.sampler, cfg),
            lambda: MLMCManager(prob.solver, prob.sampler, tcfg))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    """A checkpoint the JAX package's MLMCManager.save_state wrote (it holds
    no iteration sums) loads in the port and resumes to the JAX package's
    own resumed estimate; and a port checkpoint resumes in the JAX package."""
    JaxTimeManager.reset()
    TimeManager.reset()
    jax_mgr, port_mgr = _jax_and_port_mlmc(tmp_path, writer)
    first = jax_mgr() if writer == "jax" else port_mgr()
    first.init_run(first.init_nsamples)
    ckpt = str(tmp_path / "cross.npz")
    first.save_state(ckpt)
    first.close()
    if writer == "jax":
        assert "iter_sums" not in np.load(ckpt).files
    JaxTimeManager.reset()
    TimeManager.reset()
    jm, tm = jax_mgr(), port_mgr()
    ref, est = jm.resume(ckpt), tm.resume(ckpt)
    assert tm._counter == jm._counter > 2  # the adaptive loop ran past the first round
    np.testing.assert_array_equal(tm.level_nsamples, jm.level_nsamples)
    np.testing.assert_allclose(est, ref, rtol=1e-9)
    np.testing.assert_allclose(tm.sums, jm.sums, rtol=1e-8, atol=1e-12)
    jm.close()
    tm.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ratio_checkpoint_loads_across_packages(tmp_path, writer):
    """The same across the packages for the ratio and splitting managers:
    every key the port's BayesRatioManager.load_state reads is one the JAX
    package's save_state writes, observation data included."""
    JaxTimeManager.reset()
    TimeManager.reset()
    cfg = ProblemConfig(ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1,
                        dtype="float64", batch_size=16, initial_samples=16, mse=2e-3,
                        variance=0.25, cost_model="dofs", output_filename="",
                        bayes_ref_data_file=str(tmp_path / "ref_obs.dat"))
    cfg.darcy_solver.relative_tolerance = 1e-10
    jprob = jax_build_problem(cfg)
    jbip = JaxBIP(jprob.solver, jprob.sampler, jprob.config, jprob.dtype)
    tcfg = port_config(cfg)
    prob = build_problem(tcfg, device=CPU)
    tbip = BayesianInverseProblem(prob.solver, prob.sampler, tcfg, prob.dtype)
    for splitting in (False, True):
        first = (JaxRatioManager(jbip, cfg, splitting=splitting) if writer == "jax"
                 else BayesRatioManager(tbip, tcfg, splitting=splitting))
        first.init_run([first.init_nsamples] * first.nlevels)
        ckpt = str(tmp_path / f"ratio_{splitting}.npz")
        first.save_state(ckpt)
        jbip.G_obs = tbip.G_obs = None  # the checkpoint carries the data
        jm = JaxRatioManager(jbip, cfg, splitting=splitting)
        tm = BayesRatioManager(tbip, tcfg, splitting=splitting)
        ref, est = jm.resume(ckpt), tm.resume(ckpt)
        assert tm._counter == jm._counter > 1
        np.testing.assert_array_equal(tm.level_nsamples, jm.level_nsamples)
        np.testing.assert_allclose(est, ref, rtol=1e-9)
        np.testing.assert_allclose(to_np(tbip.G_obs), np.asarray(jbip.G_obs), rtol=0, atol=0)
