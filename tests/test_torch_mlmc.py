"""MLMC manager of the port held against the JAX package's manager on the
CPU, and the fixed-seed SMALL-config anchor of tests/test_examples.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import CPU, port_config
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy as jax_build_geometric_hierarchy
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.physics import DarcySolver as JaxDarcySolver
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.samplers import SPDESampler as JaxSPDESampler
from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
from parelagmc_tpu_torch.fem import build_geometric_hierarchy
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.physics import DarcySolver
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.samplers.pde import SPDESampler
from parelagmc_tpu_torch.uq import MLMCManager
from parelagmc_tpu_torch.utils.timing import SteadyCostLedger, TimeManager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.common import parse_config  # noqa: E402

SMALL = ["--refinements", "1", "--batch", "8", "--samples", "8", "--mse", "0.05"]


def test_mlmc_small_matches_jax_manager(tmp_path, monkeypatch):
    """Same stream, same operators, float64 and the dofs cost model (the
    walltime model makes N_l depend on the host's timings): the sample
    counts match and the estimates agree to solver precision (deep solves,
    so the two packages' rounding cannot show)."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_config(SMALL + ["--dtype", "float64", "--seed", "0"])
    cfg.cost_model = "dofs"
    cfg.output_filename = ""
    cfg.darcy_solver.relative_tolerance = 1e-10
    jprob = jax_build_problem(cfg)
    jmgr = JaxMLMCManager(jprob.solver, jprob.sampler, cfg)
    ref = jmgr.run()
    tcfg = port_config(cfg)
    prob = build_problem(tcfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, tcfg)
    est = mgr.run()
    np.testing.assert_array_equal(mgr.level_nsamples, jmgr.level_nsamples)
    np.testing.assert_allclose(est, ref, rtol=1e-9)
    np.testing.assert_allclose(mgr.eY, jmgr.eY, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mgr.varY, jmgr.varY, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(mgr.solver_iterations, jmgr.solver_iterations, rtol=0.02)


def test_mlmc_small_anchor(tmp_path, monkeypatch, capsys):
    """The examples/mlmc.py SMALL run of tests/test_examples.py:53-62 on the
    port, as examples/mlmc.py runs it (float32, walltime cost, .dat log)."""
    monkeypatch.chdir(tmp_path)
    cfg = port_config(parse_config(SMALL))
    cfg.verbose = True
    prob = build_problem(cfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    est = mgr.run()
    mgr.close()
    out = capsys.readouterr().out
    assert "FINAL MLMC ERRORS" in out and "Estimate" in out
    np.testing.assert_allclose(est, 2.24273, atol=0.02)  # the reference test's band
    # The first round already meets the variance target (N_l = 8/8), so the
    # walltime costs cannot change the sample set: the JAX package's value
    # is reproduced to its printed digits.
    assert list(mgr.level_nsamples) == [8, 8]
    np.testing.assert_allclose(est, 2.24273, rtol=1e-5)
    assert mgr.ml_estimator_variance <= mgr.ratio * mgr.eps2
    log = (tmp_path / cfg.output_filename).read_text().splitlines()
    assert len(log) == 1 + int(mgr.level_nsamples.sum())
    assert all(c < 1.0 for c in mgr.consistency)


def test_key_schedule_and_warmup_batch(tmp_path, monkeypatch):
    """Batch keys are fold_in(fold_in(key, level), counter); a single-batch
    level under the walltime model runs one discarded warm-up batch that
    moves neither the counter nor the statistics."""
    monkeypatch.chdir(tmp_path)
    cfg = port_config(parse_config(["--refinements", "1", "--batch", "4", "--samples", "4",
                                    "--dtype", "float64"]))
    cfg.output_filename = ""
    prob = build_problem(cfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    mgr.init_run([4, 4])
    assert mgr._counter == 2
    assert list(mgr.level_nsamples) == [4, 4]
    # Warm-up batches land in the ledger's first-batch slot only.
    assert list(mgr._cost_ledger.first_nsamples) == [4, 4]
    assert list(mgr._cost_ledger.nsamples) == [4, 4]


def test_steady_cost_ledger_and_timer():
    led = SteadyCostLedger(2)
    led.add_batch(0, 5.0, 8)  # first batch: program load, excluded
    assert led.cost_per_sample(0, 10.0, 8) == pytest.approx(10.0 / 8)  # fallback
    led.add_batch(0, 1.0, 8)
    led.add_batch(0, 3.0, 8)
    assert led.cost_per_sample(0, 10.0, 24) == pytest.approx(4.0 / 16)
    TimeManager.reset()
    with TimeManager.timed("t", block=lambda: torch.ones(3)):
        pass
    assert TimeManager.get_watch("t").count == 1 and TimeManager.elapsed("t") >= 0.0
    assert "t" in TimeManager.print_table()


def test_manager_rejects_sample_sharding():
    """--sample-shards 2 with one visible device (the CPU) raises
    ValueError, the reference's config rule; tests/test_torch_sharding.py
    runs the sharded managers."""
    cfg = port_config(parse_config(["--refinements", "0", "--sample-shards", "2"]))
    cfg.output_filename = ""
    prob = build_problem(cfg, device=CPU)
    with pytest.raises(ValueError, match="sample_shards=2 but only 1 device"):
        MLMCManager(prob.solver, prob.sampler, cfg)


def _managers_problem(port: bool, **kw):
    """tests/test_managers.py's build_problem (8^3 box of side 2, 3 levels,
    float64) on either package."""
    cfg = ProblemConfig(refinements=2, mse=5e-3, batch_size=16, initial_samples=16,
                        output_filename="", seed=13, **kw)
    args = ((2, 2, 2), (2.0, 2.0, 2.0))
    if port:
        hier = build_geometric_hierarchy(make_box_mesh(*args), 3)
        cfg = port_config(cfg)
        return (SPDESampler(hier, cfg, torch.float64, device=CPU),
                DarcySolver(hier, cfg, torch.float64, device=CPU), cfg)
    hier = jax_build_geometric_hierarchy(jax_make_box_mesh(*args), 3)
    return JaxSPDESampler(hier, cfg, jnp.float64), JaxDarcySolver(hier, cfg, jnp.float64), cfg


def test_split_pair_segments_run_composed_with_the_full_budget():
    """split_pair_programs + solve_segments: the reference continues each
    pair solve for up to solve_segments bounded executions; the port runs
    it as one solve with that total budget. At 10 iterations x 12 segments
    (tests/test_managers.py::test_split_pair_coarse_member_continues) the
    port's eY/eQ match the JAX package's deep composed run; with the
    budget of one segment they do not."""
    TimeManager.reset()
    sampler, solver, cfg = _managers_problem(port=False)
    ref = JaxMLMCManager(solver, sampler, cfg)
    ref.init_run([8, 8, 8])
    results = {}
    for split in (True, False):
        sampler, solver, cfg = _managers_problem(port=True, split_pair_programs=split,
                                                 solve_segments=12)
        cfg.darcy_solver.max_iterations = 10
        mgr = MLMCManager(solver, sampler, cfg)
        assert mgr.pair_budget == (120 if split else None)
        mgr.init_run([8, 8, 8])
        results[split] = (mgr.eY.copy(), mgr.eQ.copy())
    for a, b in zip((ref.eY, ref.eQ), results[True]):
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=1e-8)
    # One segment's budget leaves the pair solves unconverged (the fault the
    # repair removed: the port used to ignore solve_segments).
    assert np.abs(results[False][0] - ref.eY).max() > 1e-2
