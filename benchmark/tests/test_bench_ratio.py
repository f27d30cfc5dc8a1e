"""The ratio-step kind (kinds/ratio_steps.py) and its reference
(reference/bayes.py) on the CPU: a tiny cell of the kind runs correct and
each planted fault makes it not correct; the reference's observations,
log-likelihoods and QoI agree with the port's on a small SPE10-shaped grid;
and the readers of `like_extra_iters_pct.rate` and
`idle_in_ratio_host_pct.rate` on synthetic traced runs."""

import json
import shutil

import numpy as np
import pytest
import torch

import drive
import faults
import harness
from parelagmc_tpu_torch.utils import trace
from reference import bayes as rbayes, problem as rp, threefry
from reference.mixed import Precision
from test_bench_cells import DRIVER, run_cell
from tracedata import RunData

WELLS = [300.0, 550.0, 85.0, 600.0, 1100.0, 85.0, 900.0, 1650.0, 85.0]
BOUNDS = {"ess_attr": [0, 1, 1, 1, 1, 0], "obs_attr": [1, 0, 0, 0, 0, 0],
          "inflow_attr": [0, 0, 0, 0, 0, 1]}
# A 4 x 8 x 4 box with the SPE10 extents in two levels, float32, the
# adjoint QoI at rtol 1e-4, the likelihood's pressure to 1e-6; the wells'
# radius 0.75 of the largest cell side.
TINY = {
    "name": "tiny-bayes",
    "problem": {"mesh": "box", "ncells": [2, 4, 2], "lengths": [1200.0, 2200.0, 170.0],
                "refinements": 1, "sampler_name": "pde", "correlation_length": 100.0,
                "variance": 1.0, "lognormal": True, "normalize_marginals": True,
                "axis_order": "auto", "qoi": "eff_perm", **BOUNDS, "batch_size": 8,
                "batch_size_per_level": [8, 8], "dtype": "float32", "cost_model": "dofs",
                "split_pair_programs": True, "solve_segments": 4,
                "darcy_solver": {"name": "cg-schur", "max_iterations": 200,
                                 "relative_tolerance": 1e-4, "adjoint_qoi": True}},
    "bayes": {"wells_ft": WELLS, "eps_ft": 225.0, "noise": 0.1, "estimator": "ratio",
              "data_key": 17, "pressure_rtol": 1e-6},
    "reduced": [],
}
# Sound runs read up to 2e-5 (loglike_gap, obs_gap) and 8e-6 (r_mean_gap);
# the faults, planted at 1e-3, read 1e-3 and more.
LIMITS = {"field_gap": 1e-5, "obs_gap": 1e-4, "loglike_gap": 1e-4, "q_mean_gap": 1e-4,
          "r_mean_gap": 1e-4, "key_miss": 0, "sum_gap": 1e-9, "nonfinite": 0}


@pytest.fixture(scope="module")
def ratio_copy(tmp_path_factory):
    """The benchmark with the tiny ratio cell added as new files and
    entries."""
    root = tmp_path_factory.mktemp("ratio")
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "benchmark" / "configs" / "tiny-bayes.json").write_text(json.dumps(TINY))
    (root / "benchmark" / "traffic" / "tiny_ratio.json").write_text(json.dumps(
        {"kind": "ratio_steps", "level": 0, "batch": 8, "profile_units": 1,
         "check": {"batches": 2, "rows": 4}}))
    (root / "benchmark" / "limits" / "tiny-ratio.json").write_text(json.dumps(LIMITS))
    b = harness.load_benchmark()
    b["configs"].append({"name": "tiny-bayes", "source": "test",
                         "file": "benchmark/configs/tiny-bayes.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "tiny-ratio", "config": "tiny-bayes",
                           "traffic": "tiny_ratio", "chips": 1, "why": "t"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "spe10-l0-ratio" in m.get("workloads", []):
            m["workloads"].append("tiny-ratio")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "drive_cpu.py").write_text(DRIVER)
    return root


@pytest.mark.parametrize("fault", ("none",) + faults.FAULTS)
def test_the_ratio_cell_is_correct_and_its_faults_are_not(ratio_copy, fault):
    res, err = run_cell(ratio_copy, fault, "tiny-ratio", 2 ** 31 + 29)
    if fault == "none":
        assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, err[-2000:]
        assert set(res["metrics"]) == {"samples_per_s", "batch_ms_p90", "setup_s"}
        assert list(res["checks"]) == list(LIMITS)
        assert 0.0 < res["checks"]["loglike_gap"][0] < 1e-4
        assert 0.0 < res["checks"]["obs_gap"][0] < 1e-4
    else:
        assert res["correct"] is False, err[-2000:]
        assert res["checks"]["loglike_gap"][0] > 5e-4 and res["checks"]["r_mean_gap"][0] > 5e-4


def test_a_traced_ratio_run_reads_the_extra_iterations(ratio_copy):
    res, _ = run_cell(ratio_copy, "none", "tiny-ratio", 7, trace=1)
    assert res["correct"]
    assert 0.0 < res["metrics"]["like_extra_iters_pct.rate"]["value"] < 100.0
    assert res["metrics"]["host_syncs_per_batch.rate"]["value"] > 0
    # No device operations on the CPU: the idle shares have nothing to read.
    assert "idle_in_ratio_host_pct.rate" not in res["metrics"]


@pytest.fixture
def small_spe10(monkeypatch):
    """The SPE10 grid cut to 10 x 18 x 7 cells (of 20 x 10 x 2 ft) in three
    levels, float64, the synthetic permeability, three wells of radius 30 ft
    inside it, every solve deep: the kind's build of it and the
    reference."""
    import parelagmc_tpu_torch.problems as pp

    cells = (10, 18, 7)
    monkeypatch.setattr(pp, "SPE10_NCELLS", cells)
    monkeypatch.setattr(rp, "SPE10_CELLS", cells)
    spec = {"problem": {"mesh": "spe10", "refinements": 2, "correlation_length": 100.0,
                        "normalize_marginals": True, "axis_order": "auto", "dtype": "float64",
                        "batch_size_per_level": [4, 4, 4], **BOUNDS,
                        "darcy_solver": {"name": "cg-schur-coefmg", "max_iterations": 3000,
                                         "relative_tolerance": 1e-12, "adjoint_qoi": True}},
            "permeability": {"generator": "synthetic_spe10", "ncells": list(cells), "seed": 0},
            "bayes": {"wells_ft": [50.0, 60.0, 7.0, 110.0, 100.0, 7.0, 150.0, 150.0, 3.0],
                      "eps_ft": 30.0, "noise": 0.1,
                      "estimator": "ratio", "data_key": 17, "pressure_rtol": 1e-13}}
    kind = harness.load_kind("ratio_steps")
    built = kind.build(spec, {"level": 0, "batch": 4}, "cpu")
    return kind, built, kind.reference(spec, built["kinv"])


def test_the_reference_likelihood_matches_the_port(small_spe10, monkeypatch):
    """Observation data and log Pi of both streams' fields on every level,
    the port's against the reference's (sparse LU), to 1e-8, and Q to 1e-6
    (at the synthetic field's contrast the flux QoI carries ~1e3 x the
    residual of a deep solve); and the reference's CG against its LU."""
    from parelagmc_tpu_torch.uq.managers import eval_pair

    kind, built, ref = small_spe10
    prob, prec = built["problem"], Precision()
    assert ref.problem.order == [1, 0, 2] and [g.shape[0] for g in ref.g] == [3, 3, 3]
    lu = rbayes.solver_for("cpu")
    y_ref = ref.observations(lu, prec)
    np.testing.assert_allclose(prob.bip.G_obs.numpy(), y_ref, rtol=1e-8)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(2 ** 31 + 3 + 101), 0), 1)
    for k in (rbayes.split_key(key, 0), rbayes.split_key(key, 1)):
        for level in (0, 1):
            w_f, w_c = eval_pair(prob.sampler, level, prob.sampler.sample(level, k, 4))
            for lv, w in ((level, w_f), (level + 1, w_c)):
                like, q, _ = prob.bip.likelihood_and_Q(lv, w)
                q_ref, l_ref = ref.evaluate(lv, ref.problem.coefficients(
                    k, 4, [0, 1, 2, 3], level, lv, prec), lu, y_ref)
                np.testing.assert_allclose(torch.log(like).numpy(), l_ref, rtol=0, atol=1e-8)
                np.testing.assert_allclose(q.numpy(), q_ref, rtol=1e-6)
    monkeypatch.setattr(rbayes, "DIRECT_MAX", 0)
    w = ref.problem.coefficients(k, 4, [0, 1, 2, 3], 0, 0, prec)
    for (a, b) in zip(rbayes.solver_for("cpu", rtol=1e-12)(ref.problem.darcy[0], w),
                      lu(ref.problem.darcy[0], w)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_the_schedule_keys_are_the_managers(small_spe10):
    """The Z and R keys the check expects are the ratio manager's."""
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in, split

    key = fold_in(fold_in(PRNGKey(2 ** 33 + 1 + 101), 0), 3)
    assert small_spe10[0].schedule_keys(2 ** 33 + 1, 0, 3) == split(key)


T0 = 10.0  # the profiled unit's start on the host clock, s


def _span(name, index, parent, a_us, b_us, **attrs):
    s = trace.Span(name, index, parent, (0, 1), attrs)
    s.t0, s.t1 = int((T0 + a_us * 1e-6) * 1e9), int((T0 + b_us * 1e-6) * 1e9)
    return s


def _run(monkeypatch, spans, kernels):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return RunData(spans=[("unit", T0, T0 + 1e-3, 0, 0)], units=[(T0, T0 + 1e-3, 8)],
                   ranges=[("bench.unit", 5000.0, 6000.0)], kernels=kernels,
                   solves=[(0, 0, 2, 0)], profile_units=1)


# One ratio batch on host us 10-990 of a profiled unit (bench.unit 5000-6000
# us): a likelihood around a solve and its read-off, the copy and the sums.
RATIO = [
    _span("mlmc.batch", 0, -1, 10, 990, manager="ratio",
          counters={"krylov.iterations": 40, "krylov.extra_iterations": 10,
                    "host_syncs.krylov_test": 42, "host_syncs.ratio_copy": 1}),
    _span("bayes.likelihood", 1, 0, 20, 600, level=0),
    _span("darcy.solve", 2, 1, 30, 500, level=0),
    _span("bayes.G", 3, 1, 500, 560, level=0),
    _span("wait.ratio_copy", 4, 0, 700, 800),
    _span("ratio.moments", 5, 0, 800, 900),
    _span("mlmc.batch", 6, -1, 5000, 6000),  # outside the profiled unit
]
# Busy 0-100, 200-500, 620-750, 950-1000: idle 100 in darcy.solve (midpoint
# 150), 120 in bayes.likelihood (midpoint 560 after bayes.G), 200 in
# ratio.moments (midpoint 850).
KERNELS = [("k", 5000.0 + a, 5000.0 + b) for a, b in ((0, 100), (200, 500), (620, 750),
                                                      (950, 1000))]


def test_the_ratio_readers_on_a_synthetic_run(monkeypatch):
    run = _run(monkeypatch, RATIO, KERNELS)
    assert harness.load_reader("like_extra_iters_pct.rate")(run) == pytest.approx(25.0)
    assert harness.load_reader("idle_in_ratio_host_pct.rate")(run) == pytest.approx(
        100.0 * 320 / 420)


@pytest.mark.parametrize("counters,want", [
    ({"krylov.iterations": 40}, 0.0),  # no pressure tolerance: nothing extra
    ({"host_syncs.krylov_test": 3}, None),  # no Krylov iteration counted
])
def test_the_extra_share_without_the_counter(monkeypatch, counters, want):
    spans = [_span("mlmc.batch", 0, -1, 10, 990, counters=counters)]
    got = harness.load_reader("like_extra_iters_pct.rate")(_run(monkeypatch, spans, KERNELS))
    assert got == want


def test_the_ratio_readers_read_nothing_on_a_pair_step(monkeypatch):
    """A run without the ratio step's spans (a pair step, or the parent
    program) and an untraced run read None, and neither raises."""
    pair = [_span("mlmc.batch", 0, -1, 10, 990, counters={"host_syncs.krylov_test": 3}),
            _span("darcy.solve", 1, 0, 30, 500, level=0)]
    run = _run(monkeypatch, pair, KERNELS)
    for name in ("like_extra_iters_pct.rate", "idle_in_ratio_host_pct.rate"):
        assert harness.load_reader(name)(run) is None
        assert harness.load_reader(name)(RunData(units=[(T0, T0 + 1e-3, 8)])) is None


def test_the_configuration_holds_spe10_and_its_wells():
    """spe10-bayes is spe10's problem, permeability and cut, with the
    port's example's wells; the reference reads its bayes block."""
    b = harness.load_benchmark()
    files = {c["name"]: harness.load_json(harness.ROOT + "/" + c["file"]) for c in b["configs"]}
    spe10, bayes = files["spe10"], files["spe10-bayes"]
    for key in ("problem", "permeability", "reduced"):
        assert bayes[key] == spe10[key]
    assert set(spe10["assumed"]) <= set(bayes["assumed"])
    from parelagmc_tpu_torch.examples import spe10_ratio_mlmc

    assert tuple(bayes["bayes"]["wells_ft"]) == spe10_ratio_mlmc.OBS_COORDS
    assert bayes["bayes"]["eps_ft"] == spe10_ratio_mlmc.OBS_EPS
    assert bayes["bayes"]["pressure_rtol"] == spe10_ratio_mlmc.PRESSURE_RTOL
    assert drive.problem_config(bayes).bayes_noise == bayes["bayes"]["noise"]
