"""The likelihood's pressure tolerance (`BayesianInverseProblem(...,
pressure_rtol=)`), the ratio manager's spans and counters, and the two
walltime-ledger repairs, on the port alone, on the CPU.

The fault it cures: G = <g, p> reads the primal pressure of a solve that
stops at the configuration's rtol, which the adjoint correction makes
enough for Q but not for p. On a box with the SPE10 extents and the
synthetic permeability at full contrast (6 x 22 x 8 cells, the production
solver settings in float32), G at rtol 1e-4 parts from a float64 deep
solve by 4.6e-2 (relative) at level 0, and by 3.8e-4 with the pressure to
1e-6 (measured on a CPU); the tests hold the two sides of that gap with
room, 1e-2 and 2e-3."""

import dataclasses

import numpy as np
import pytest
import torch

from parelagmc_tpu_torch.config import ProblemConfig, SolverConfig
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.physics import spe10
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager, MLMCManager
from parelagmc_tpu_torch.utils import trace
from parelagmc_tpu_torch.utils.timing import SteadyCostLedger, TimeManager

CPU = torch.device("cpu")
GRID = (6, 22, 8)
WELLS = (300.0, 550.0, 85.0, 600.0, 1100.0, 85.0, 900.0, 1650.0, 85.0)
# The production solver settings of the full grid (physics/spe10.py).
PRODUCTION = dict(name="cg-schur-coefmg", max_iterations=75, relative_tolerance=1e-4,
                  adjoint_qoi=True, coefmg_cheby_order=3, coefmg_cheby_lo=0.1,
                  coefmg_prec_dtype="bfloat16", meanfield_x0=True)


def spe10_box(dtype="float32", **solver):
    """The 6 x 22 x 8 box with the SPE10 extents in two levels, the three
    wells of examples/spe10_ratio_mlmc.py (radius widened to 0.75 of the
    largest cell side), the synthetic permeability."""
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    eps = max(30.0, 0.75 * max(L / n for L, n in zip(lengths, GRID)))
    cfg = ProblemConfig(
        mesh="box", ncells=tuple(g // 2 for g in GRID), lengths=lengths, refinements=1,
        correlation_length=100.0, normalize_marginals=True, axis_order="auto", dtype=dtype,
        bayes_num_obs=3, bayes_obs_coords=WELLS, bayes_eps=eps, bayes_ref_data_file="",
        output_filename="", batch_size=4, initial_samples=4, cost_model="dofs",
        split_pair_programs=True, solve_segments=4,
        darcy_solver=SolverConfig(**{**PRODUCTION, **solver}))
    return build_problem(cfg, kinv_ref=spe10.load_spe10_kinv(None, ncells=GRID), device=CPU)


@pytest.fixture(scope="module")
def box():
    return spe10_box()


def fields(prob, level, batch=8):
    return prob.sampler.eval(level, prob.sampler.sample(level, PRNGKey(5 + level), batch))


def test_pressure_rtol_cures_the_unconverged_pressure(box):
    """F1 at small size: G at the configuration's rtol parts from a
    float64 deep solve by more than 1e-2 at level 0; with the pressure to
    1e-6 every G of both levels is within 2e-3 of it."""
    truth = spe10_box("float64", relative_tolerance=1e-12, max_iterations=5000,
                      coefmg_prec_dtype="", adjoint_qoi=False)
    deep = BayesianInverseProblem(truth.solver, truth.sampler, truth.config, truth.dtype)
    for level in (0, 1):
        w = fields(box, level)
        want = deep.compute_G(level, w.double())[0].numpy()
        gaps = {}
        for rtol in (None, 1e-6):
            bip = BayesianInverseProblem(box.solver, box.sampler, box.config, box.dtype,
                                         pressure_rtol=rtol)
            got, _, _, info = bip.compute_G(level, w, max_iters=300, return_info=True)
            assert bool(info.converged.all())
            gaps[rtol] = float(np.max(np.abs(got.double().numpy() - want) / np.abs(want)))
        assert gaps[1e-6] < 2e-3, gaps
        if level == 0:
            assert gaps[None] > 1e-2, gaps


@pytest.mark.parametrize("rtol", [None, 1e-3])
def test_no_tighter_tolerance_is_todays_likelihood(box, rtol):
    """pressure_rtol None, or one at or above the configuration's, gives
    bit for bit the G, Pi and R of the configuration's own solve, and runs
    no extra iteration."""
    bip = BayesianInverseProblem(box.solver, box.sampler, box.config, box.dtype,
                                 pressure_rtol=rtol)
    bip.set_observational_data([0.3, 0.1, 0.6])
    w = fields(box, 0, 4)
    q, _, _, p = box.solver.solve_fwd(0, w, return_pressure=True)
    G = torch.matmul(p, bip.g_obs[0].T)
    like = torch.exp(-torch.sum((G - bip.G_obs) ** 2, dim=-1) / (2.0 * bip.noise))
    n0 = trace.counters("krylov")["extra_iterations"]
    assert torch.equal(bip.compute_G(0, w)[0], G)
    assert torch.equal(bip.likelihood(0, w)[0], like)
    assert torch.equal(bip.compute_R(0, w)[0], q * like)
    assert trace.counters("krylov")["extra_iterations"] == n0


def test_extra_iterations_count_up_with_the_tolerance(box):
    """`krylov.extra_iterations` only grows: by nothing at the
    configuration's tolerance, by the iterations run past it otherwise, and
    more for a tighter pressure tolerance."""
    w = fields(box, 0)
    extra, iters = {}, {}
    for rtol in (None, 1e-5, 1e-7):
        bip = BayesianInverseProblem(box.solver, box.sampler, box.config, box.dtype,
                                     pressure_rtol=rtol)
        n0 = trace.counters("krylov")["extra_iterations"]
        iters[rtol] = bip.compute_G(0, w, return_info=True)[3].iterations
        extra[rtol] = trace.counters("krylov")["extra_iterations"] - n0
    assert extra[None] == 0 < extra[1e-5] < extra[1e-7], extra
    # The adjoint keeps the configuration's tolerance: the extra iterations
    # are what the primal adds.
    assert iters[1e-7] - iters[None] == extra[1e-7], (iters, extra)


@pytest.mark.parametrize("rtol", [None, 1e-6])
def test_ratio_batch_spans_and_counters(box, rtol, monkeypatch, capsys):
    """Under PARELAGMC_BATCH_TRACE a ratio batch is an `mlmc.batch` span
    (manager "ratio") holding `wait.ratio_copy`, `ratio.moments`, four
    `bayes.likelihood` and their `bayes.G`; its host syncs are the Krylov
    loops' continue and exit tests and the one copy, with or without a
    pressure tolerance (the second test rides in the continue test's read).
    The batch's `# batch-trace ratio` line carries its totals."""
    monkeypatch.setattr(trace, "BATCH_TRACE", True)
    trace.reset()
    bip = BayesianInverseProblem(box.solver, box.sampler, box.config, box.dtype,
                                 pressure_rtol=rtol)
    bip.set_observational_data([0.3, 0.1, 0.6])
    mgr = BayesRatioManager(bip, box.config)
    mgr.init_run([4, 0])
    spans = trace.spans()
    batch = [s for s in spans if s.name == "mlmc.batch"]
    assert len(batch) == 1 and batch[0].attrs["manager"] == "ratio"
    assert batch[0].batch == (0, 1) and batch[0].attrs["rows"] == 4
    inside = [s for s in spans if s.batch == (0, 1)]
    names = [s.name for s in inside]
    for name, n in (("wait.ratio_copy", 1), ("ratio.moments", 1), ("bayes.likelihood", 4),
                    ("bayes.G", 4), ("darcy.solve", 4)):
        assert names.count(name) == n, (name, names.count(name))
    for name in ("bayes.likelihood", "bayes.G"):
        assert [(s.attrs["level"], s.attrs["rows"]) for s in inside if s.name == name] == [
            (0, 4), (1, 4), (0, 4), (1, 4)]
    delta = batch[0].attrs["counters"]
    pcgs = names.count("krylov.pcg")
    assert delta["host_syncs.krylov_test"] == delta["krylov.iterations"] + pcgs
    assert delta["host_syncs.ratio_copy"] == 1
    assert set(k for k in delta if k.startswith("host_syncs.")) <= {
        "host_syncs.krylov_test", "host_syncs.krylov_verify", "host_syncs.ratio_copy"}
    assert (delta.get("krylov.extra_iterations", 0) > 0) == (rtol is not None)
    (line,) = [l for l in capsys.readouterr().err.splitlines()
               if l.startswith("# batch-trace ratio L0 ")]
    got = dict(f.split("=", 1) for f in line.split()[4:])
    totals = trace.batch_totals(batch[0])
    assert {"dt", "t", "setup_ms", "krylov_ms", "wait_ms", "host_syncs", "restarts",
            "extra_iterations"} == set(got)
    assert int(got["host_syncs"]) == totals["host_syncs"] > 0
    assert int(got["extra_iterations"]) == delta.get("krylov.extra_iterations", 0)
    assert 0 < float(got["krylov_ms"]) < (batch[0].t1 - batch[0].t0) * 1e-6


def test_pressure_rtol_reaches_the_spatially_sharded_solve():
    """With spatial_shards the likelihood's tolerance reaches the sharded
    primal (float64): G parts from a deep solve by more than 1e-2 at the
    configuration's rtol and by less than 1e-5 with the pressure to 1e-8
    (2.7e-2 and 9.8e-7 measured on a CPU), in more iterations."""
    truth = spe10_box("float64", relative_tolerance=1e-12, max_iterations=5000,
                      coefmg_prec_dtype="", adjoint_qoi=False)
    sharded = spe10_box("float64", coefmg_prec_dtype="", spatial_shards=2)
    w = fields(sharded, 0, 4)
    want = BayesianInverseProblem(truth.solver, truth.sampler, truth.config,
                                  truth.dtype).compute_G(0, w)[0].numpy()
    gaps, iters = {}, {}
    for rtol in (None, 1e-8):
        bip = BayesianInverseProblem(sharded.solver, sharded.sampler, sharded.config,
                                     sharded.dtype, pressure_rtol=rtol)
        G, _, _, info = bip.compute_G(0, w, max_iters=500, return_info=True)
        assert bool(info.converged.all()), rtol
        gaps[rtol] = float(np.max(np.abs(G.numpy() - want) / np.abs(want)))
        iters[rtol] = int(torch.as_tensor(info.iterations).max())
    assert gaps[1e-8] < 1e-5 and gaps[None] > 1e-2, gaps
    assert iters[1e-8] > iters[None], iters


@pytest.mark.parametrize("manager", ["mlmc", "ratio"])
def test_walltime_warmup_skipped_when_the_ledger_holds_samples(box, manager):
    """A single-batch level under the walltime cost model runs a discarded
    warm-up batch, unless the ledger already holds steady samples of the
    level (a resumed run): then one step, not two."""
    TimeManager.reset()
    cfg = dataclasses.replace(box.config, cost_model="walltime")
    if manager == "mlmc":
        mgr = MLMCManager(box.solver, box.sampler, cfg)
    else:
        bip = BayesianInverseProblem(box.solver, box.sampler, cfg, box.dtype)
        bip.set_observational_data([0.3, 0.1, 0.6])
        mgr = BayesRatioManager(bip, cfg)
    step = mgr._step(1)
    calls = []
    mgr._steps[1] = lambda key: calls.append(key) or step(key)
    mgr.init_run([0, 4])
    assert len(calls) == 2  # the warm-up and the batch
    resumed = SteadyCostLedger(2)
    resumed.load(mgr._cost_ledger.state())
    mgr._cost_ledger = resumed  # a new process: level 1 not seen, samples held
    calls.clear()
    mgr.init_run([0, 4])
    assert len(calls) == 1


def test_ledger_of_another_length_loads_as_zeros():
    """SteadyCostLedger.load takes a checkpoint's ledger only where its
    arrays have one entry a level; otherwise it falls back to zeros."""
    ledger = SteadyCostLedger(3)
    ledger.add_batch(0, 1.0, 8)
    ledger.add_batch(0, 0.5, 8)
    short = SteadyCostLedger(2)
    short.add_batch(1, 1.0, 4)
    short.add_batch(1, 1.0, 4)
    ledger.load(short.state())
    for v in ledger.state().values():
        np.testing.assert_array_equal(v, np.zeros(3))
    ledger.load(dict(SteadyCostLedger(3).state(), cost_ss_n=np.array([1, 2, 3])))
    np.testing.assert_array_equal(ledger.nsamples, [1, 2, 3])
