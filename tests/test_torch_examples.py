"""The port's command-line drivers (parelagmc_tpu_torch/examples/) against
the JAX package's examples/: the same config from the same command line,
the same printed lines and estimates from each main(), the pins of
tests/test_examples.py, the launch rule and no fallback to the CPU.

Both packages run on the CPU; the twins get `--device cpu`. Lines are
compared number by number after the timing rows (costs, C_l, Gamma,
samples/s) are dropped: in float32 at the drivers' own solver tolerance
to 1e-4 of each line's largest entry, in float64 with deep solves
(`--solver-opt relative_tolerance=1e-10`) to 1e-6. Both at once: the text
between the numbers must be identical (the dof and level rows)."""

import dataclasses
import importlib
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread count)
from _torch_parity import CPU, general_mesh, port_config, write_general_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from examples import common as jcommon  # noqa: E402
from parelagmc_tpu_torch.examples import common as tcommon  # noqa: E402

SMALL = ["--refinements", "1", "--batch", "8", "--samples", "8", "--mse", "0.05"]
F64 = ["--dtype", "float64", "--seed", "0"]
DEEP = ["--solver-opt", "relative_tolerance=1e-10"]
DRIVERS = ["mlmc", "slmc", "mlmc_manual", "ratio_estimator_mc", "ratio_estimator_mlmc",
           "likelihood_example", "compute_reference_obs_data", "spe10_mlmc",
           "spe10_ratio_mlmc", "darcy_test", "darcy_random_input", "sampler_test",
           "realization_test", "sampler_performance"]
# Printed rows that hold times (or are computed from them), or Krylov
# iteration counts, which CG may end one apart in the two packages.
TIMING_ROWS = ("C_l", "Cost", "Gamma", "V[Y_l]*C_l", "Solver iterations", "samples/sec",
               "sec/sample", "written:", "canary")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
INTEGER = re.compile(r"[-+]?\d+")
SPACE = re.compile(r"\s+")

XML = """<ParameterList name="Master">
  <ParameterList name="Problem parameters">
    <Parameter name="Correlation length" type="double" value="0.2"/>
    <Parameter name="Variance" type="double" value="0.5"/>
    <Parameter name="Serial refinement levels" type="int" value="0"/>
    <Parameter name="Parallel refinement levels" type="int" value="1"/>
    <Parameter name="Number of samples" type="int" value="12"/>
    <Parameter name="Mean square error" type="double" value="0.01"/>
    <Parameter name="Essential attributes" type="vector_int" value="0 1 1 1 1 0"/>
  </ParameterList>
  <ParameterList name="Bayesian inverse problem parameters">
    <Parameter name="Noise" type="double" value="0.05"/>
  </ParameterList>
</ParameterList>
"""


def _module(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run_main(pkg, name, argv, capsys):
    """(return value, stdout) of one driver's main; the twin on the CPU."""
    argv = list(argv) + (["--device", "cpu"] if pkg != "examples" else [])
    capsys.readouterr()
    result = _module(pkg, name).main(argv)
    return result, capsys.readouterr().out


def _scalar(result):
    """A driver's return value as the number it stands for: the estimate
    (a float, a manager, or (estimate, manager))."""
    if isinstance(result, tuple):
        result = result[0]
    if hasattr(result, "estimate"):
        result = result.estimate
    return None if result is None else float(result)


def assert_same_output(out, ref, rtol):
    """The printed lines agree (timing rows dropped): the same text between
    the numbers, whitespace aside; integers equal where both print one (dofs,
    levels, sample counts); with rtol <= 1e-6 (float64, deep solves) every
    number of a line within rtol of the line's largest one. In float32 a
    line's statistics are held only through the estimate (run_both)."""
    mine = [l for l in out.splitlines() if not any(t in l for t in TIMING_ROWS)]
    theirs = [l for l in ref.splitlines() if not any(t in l for t in TIMING_ROWS)]
    assert len(mine) == len(theirs), (out, ref)
    for a, b in zip(mine, theirs):
        assert SPACE.sub(" ", NUMBER.sub("#", a)) == SPACE.sub(" ", NUMBER.sub("#", b)), (a, b)
        ta, tb = NUMBER.findall(a), NUMBER.findall(b)
        for u, v in zip(ta, tb):
            if INTEGER.fullmatch(u) and INTEGER.fullmatch(v):
                assert int(u) == int(v), (a, b)
        if tb and rtol <= 1e-6:
            x, y = np.array([float(v) for v in ta]), np.array([float(v) for v in tb])
            scale = max(np.abs(y).max(), 1e-300)
            assert np.abs(x - y).max() <= rtol * scale, (a, b)


def run_both(name, argv, capsys, rtol):
    """Run the original and the twin; hold output and return value."""
    ref_result, ref = run_main("examples", name, argv, capsys)
    result, out = run_main("parelagmc_tpu_torch.examples", name, argv, capsys)
    assert_same_output(out, ref, rtol)
    if _scalar(ref_result) is None:
        assert _scalar(result) is None
    else:
        np.testing.assert_allclose(_scalar(result), _scalar(ref_result), rtol=rtol)
    return result, out


# -- the command line ------------------------------------------------------------

ARGVS = {
    "defaults": [],
    "every-scalar": ["--mesh", "spe10", "--sampler", "matern", "--embedding", "projection",
                     "--projection-order", "1", "--refinements", "3", "--corlen", "0.3",
                     "--variance", "0.5", "--mse", "1e-2", "--samples", "16", "--batch", "4",
                     "--qoi", "p_int", "--dtype", "float64", "--seed", "7", "--no-lognormal",
                     "--normalize-marginals", "--axis-order", "1,0,2", "--coarse-ops",
                     "rediscretize", "--output", "x.dat", "--verbose"],
    "mesh-file": ["--mesh", "cube.mesh", "--agglomerate", "--coarsening-factor", "4",
                  "--ess-attr", "1,0,0", "--obs-attr", "0,1,0", "--inflow-attr", "0,0,1",
                  "--raw-marginals", "--axis-order", "auto", "--sample-shards", "-1"],
    "solver-opts": ["--spatial-shards", "2", "--spatial-sample-shards", "2",
                    "--solver-opt", "coefmg_cheby_order=3", "--solver-opt", "coefmg_cheby_lo=0.10",
                    "--solver-opt", "coefmg_prec_dtype=bfloat16", "--solver-opt",
                    "local_schur_scaling=true", "--solver-opt", "name=cg-schur-coefmg",
                    "--axis-order", "none", "--embedding", "matching", "--sampler", "analytic",
                    "--qoi", "local_avg_p", "--dtype", "bfloat16", "--output", ""],
    "xml": ["--xml-file", "{xml}"],
    "xml-short-flag-overridden": ["-f", "{xml}", "--samples", "4", "--corlen", "0.4"],
    "xml-refinements-cleared": ["-f", "{xml}", "--refinements", "1"],
}
DEFAULTS = {
    "none": {},
    "slmc": dict(mse=5e-3),
    "spe10": dict(mse=-1.0, mesh="spe10", refinements=1, correlation_length=100.0,
                  initial_samples=32, batch_size=32, normalize_marginals=True,
                  axis_order="auto"),
    "nlevels": dict(nlevels=2, refinements=3),
}


@pytest.mark.parametrize("defaults", list(DEFAULTS))
@pytest.mark.parametrize("case", list(ARGVS))
def test_parse_config_matches_the_original(tmp_path, case, defaults):
    """Every option, the XML list, the drivers' own defaults and their
    precedence (XML, then defaults, then overrides; --refinements clears
    nlevels) give the original's config field by field; --device is read
    and left out of the config."""
    xml = tmp_path / "list.xml"
    xml.write_text(XML)
    argv = [a.format(xml=xml) for a in ARGVS[case]]
    kw = DEFAULTS[defaults]
    ref = jcommon.parse_config(list(argv), **kw)
    cfg = tcommon.parse_config(list(argv), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_config(ref))
    assert cfg.nlevels == ref.nlevels
    cfg2, device = tcommon.parse_args(list(argv) + ["--device", "cpu"], **kw)
    assert device == CPU and dataclasses.asdict(cfg2) == dataclasses.asdict(cfg)


def test_parse_config_reads_the_xml_list(tmp_path):
    xml = tmp_path / "list.xml"
    xml.write_text(XML)
    cfg = tcommon.parse_config(["-f", str(xml)])
    assert (cfg.correlation_length, cfg.variance, cfg.refinements, cfg.nlevels) == (0.2, 0.5, 1, 2)
    assert (cfg.initial_samples, cfg.mse, cfg.bayes_noise) == (12, 0.01, 0.05)
    cfg = tcommon.parse_config(["-f", str(xml), "--refinements", "2"], nlevels=5)
    assert (cfg.refinements, cfg.nlevels) == (2, 3)


@pytest.mark.parametrize("opt", ["no_such_field=1", "coefmg_cheby_order", "=3"])
def test_apply_solver_opt_errors_alike(opt):
    """An unknown field or a missing '=' exits in both; a good option
    coerces to the field's type (tests/test_config.py's cases)."""
    for common in (jcommon, tcommon):
        with pytest.raises(SystemExit):
            common.parse_config(["--solver-opt", opt])
    cfg = tcommon.parse_config([
        "--solver-opt", "coefmg_cheby_order=3", "--solver-opt", "coefmg_cheby_lo=0.10",
        "--solver-opt", "coefmg_prec_dtype=bfloat16", "--solver-opt", "local_schur_scaling=true",
        "--solver-opt", "adjoint_qoi=0"])
    ds = cfg.darcy_solver
    assert (ds.coefmg_cheby_order, ds.coefmg_cheby_lo, ds.coefmg_prec_dtype) == (3, 0.10, "bfloat16")
    assert ds.local_schur_scaling is True and ds.adjoint_qoi is False


def test_spe10_full_grid_solver_defaults():
    """tests/test_examples.py::test_spe10_full_grid_solver_defaults on the
    twin: the production defaults, and explicit --solver-opt overrides win
    over every one; each case equals the original's config."""
    from examples.spe10_mlmc import full_grid_solver_defaults as jdefaults
    from parelagmc_tpu_torch.examples.spe10_mlmc import full_grid_solver_defaults

    def both(argv):
        cfg = full_grid_solver_defaults(tcommon.parse_config(list(argv), mesh="spe10"), argv)
        ref = jdefaults(jcommon.parse_config(list(argv), mesh="spe10"), argv)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(port_config(ref))
        return cfg

    cfg = both([])
    ds = cfg.darcy_solver
    assert ds.name == "cg-schur-coefmg"
    assert ds.adjoint_qoi and ds.relative_tolerance == 1e-4
    assert ds.max_iterations == 75
    assert ds.coefmg_cheby_order == 3 and ds.coefmg_cheby_lo == 0.10
    assert ds.coefmg_prec_dtype == "bfloat16"
    assert ds.meanfield_x0
    assert not ds.adjoint_stacked
    assert cfg.split_pair_programs and cfg.solve_segments == 4
    assert cfg.batch_size_per_level[:2] == [8, 128]

    ds = both(["--solver-opt", "meanfield_x0=false", "--solver-opt",
               "adjoint_stacked=true"]).darcy_solver
    assert not ds.meanfield_x0
    assert ds.adjoint_stacked

    ds = both(["--solver-opt", "adjoint_qoi=false"]).darcy_solver
    assert not ds.adjoint_qoi
    assert ds.relative_tolerance == 1e-6 and ds.max_iterations == 150

    ds = both(["--solver-opt", "relative_tolerance=1e-5", "--solver-opt", "coefmg_cheby_order=0",
               "--solver-opt", "max_iterations=60"]).darcy_solver
    assert ds.relative_tolerance == 1e-5
    assert ds.coefmg_cheby_order == 0
    assert ds.max_iterations == 60


def test_spe10_ratio_build_config():
    """spe10_ratio_mlmc.build_config: the wells of the original (radius
    widened on a scaled grid), the scaled box with the SPE10 extents, the
    options taken out of argv; the kinv of the synthetic permeability."""
    from parelagmc_tpu_torch.examples import spe10_ratio_mlmc

    argv = ["--grid", "16,32,8", "--refinements", "1", "--samples", "8", "--batch", "8",
            "--dtype", "float64", "--splitting", "--out", "ev.json"]
    cfg, device, kinv, opts = spe10_ratio_mlmc.build_config(argv + ["--device", "cpu"])
    assert device == CPU and kinv.shape == (16 * 32 * 8, 3)
    assert opts == dict(splitting=True, adaptive=False, perm_file=None, grid=(16, 32, 8),
                        out="ev.json")
    assert cfg.mesh == "box" and cfg.ncells == (8, 16, 4) and cfg.nlevels == 2
    assert cfg.lengths == (1200.0, 2200.0, 170.0)
    assert cfg.bayes_num_obs == 3 and cfg.bayes_obs_coords == spe10_ratio_mlmc.OBS_COORDS
    assert cfg.bayes_eps == 0.75 * 1200.0 / 16 and cfg.bayes_ref_data_file == ""
    assert (cfg.mse, cfg.initial_samples, cfg.dtype) == (1e10, 8, "float64")
    assert cfg.darcy_solver.name == "cg-schur"  # scaled grids keep the default solver


# -- each twin's main against the original's ----------------------------------------

# (driver, argv, rtol, pin (value, atol or None, rtol or None), printed marker)
PARITY = {
    "mlmc-f32": ("mlmc", SMALL, 1e-4, (2.24273, 0.02, None), "FINAL MLMC ERRORS"),
    "mlmc-f64": ("mlmc", SMALL + F64 + DEEP, 1e-6, None, "FINAL MLMC ERRORS"),
    "mlmc-xml-f64": ("mlmc", ["-f", "{xml}", "--batch", "8", "--mse", "1e10"] + F64 + DEEP, 1e-6,
                     None,
                     "FINAL MLMC ERRORS"),
    "slmc-f32": ("slmc", SMALL, 1e-4, (2.21055, 0.02, None), "FINAL SLMC ERRORS"),
    "slmc-f64": ("slmc", SMALL + F64 + DEEP, 1e-6, None, "FINAL SLMC ERRORS"),
    "mlmc_manual-f32": ("mlmc_manual", SMALL, 1e-4, (2.48959, 0.02, None), "MLMC estimate"),
    "mlmc_manual-f64": ("mlmc_manual", SMALL + F64 + DEEP, 1e-6, None, "MLMC estimate"),
    "ratio_estimator_mc-f64": ("ratio_estimator_mc", SMALL + F64 + DEEP, 1e-6,
                               (2.24332, None, 0.05), "FINAL SL_BayesRatio_Manager ERRORS"),
    "ratio_estimator_mc-splitting-f64": ("ratio_estimator_mc", SMALL + F64 + DEEP + ["--splitting"],
                                         1e-6, (2.24155, None, 0.05), "Splitting Estimate"),
    "ratio_estimator_mc-f32": ("ratio_estimator_mc", SMALL, 1e-4, None,
                               "FINAL SL_BayesRatio_Manager ERRORS"),
    "ratio_estimator_mlmc-f64": ("ratio_estimator_mlmc", SMALL + F64 + DEEP, 1e-6, None,
                                 "FINAL ML_BayesRatio_Manager ERRORS"),
    "likelihood_example-f64": ("likelihood_example", ["--refinements", "1"] + F64 + DEEP, 1e-6,
                               None, "L = 1 : "),
    "compute_reference_obs_data-f64": ("compute_reference_obs_data",
                                       ["--refinements", "1"] + F64, 1e-6, None,
                                       "reference observational data"),
    "darcy_test-f32": ("darcy_test", ["--refinements", "1"], 1e-4, None, "DarcyTest"),
    "darcy_random_input-f64": ("darcy_random_input", ["--refinements", "1"] + F64 + DEEP, 1e-6,
                               None, "DarcyTest_RandomInput"),
    "darcy_random_input-f32": ("darcy_random_input", ["--refinements", "1"], 1e-4, None,
                               "DarcyTest_RandomInput"),
    "spe10_mlmc-f32": ("spe10_mlmc", ["--grid", "8,12,4", "--refinements", "1", "--samples", "4",
                                      "--batch", "4", "--mse", "1e10"], 1e-4,
                       (487.129, None, 0.01), "Estimate"),
    "spe10_mlmc-f64": ("spe10_mlmc", ["--grid", "8,12,4", "--refinements", "1", "--samples", "4",
                                      "--batch", "4", "--mse", "1e10"] + F64 + DEEP, 1e-6, None,
                       "Estimate"),
    "spe10_ratio_mlmc-f64": ("spe10_ratio_mlmc", ["--grid", "8,16,4", "--refinements", "1",
                                                  "--samples", "4", "--batch", "4", "--out",
                                                  "ev.json"] + F64 + DEEP, 1e-6, None,
                             "FINAL ML_BayesRatio_Manager ERRORS"),
    "sampler_performance": ("sampler_performance", ["--refinements", "1", "--batch", "8"], 1e-4,
                            None, "samples/sec"),
    "sampler_test-f64": ("sampler_test", ["--refinements", "1", "--batch", "4", "--samples", "1",
                                          "--corlen", "0.4"] + F64, 1e-6, None,
                         "SPDE-projection"),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_main_matches_the_original(case, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "list.xml").write_text(XML)
    name, argv, rtol, pin, marker = PARITY[case]
    argv = [a.format(xml=tmp_path / "list.xml") for a in argv]
    result, out = run_both(name, argv, capsys, rtol)
    assert marker in out
    if pin is not None:
        value, atol, prtol = pin
        np.testing.assert_allclose(_scalar(result), value, atol=atol or 0, rtol=prtol or 0)
    if name == "spe10_ratio_mlmc":
        ev = json.loads((tmp_path / "ev.json").read_text())
        assert ev["posterior_estimate"] == _scalar(result) and ev["N_l"] == [4, 4]
        assert all(c["converged_fraction"] == 1.0 for c in ev["solver_canary"])
    if name == "compute_reference_obs_data":
        data = np.loadtxt(tmp_path / out.split("-> ")[1].split(":")[0])
        assert np.isfinite(data).all()


def test_twin_pins_of_the_golden_config(capsys, tmp_path, monkeypatch):
    """The pins of tests/test_examples.py on the golden box (refinements 2):
    darcy_random_input's per-level Q and likelihood_example's per-level
    likelihood in float64 (rtol 1e-4), dofs 17152 / 2240 / 304."""
    monkeypatch.chdir(tmp_path)
    args = ["--refinements", "2", "--dtype", "float64", "--seed", "0"]
    _, out = run_main("parelagmc_tpu_torch.examples", "darcy_random_input", args, capsys)
    rows = {int(p[0]): (float(p[1]), int(p[2])) for p in map(str.split, out.splitlines())
            if len(p) == 3 and p[0] in ("0", "1", "2")}
    assert [rows[l][1] for l in (0, 1, 2)] == [17152, 2240, 304]
    for l, pin in ((0, 2.6480155), (1, 2.7483976), (2, 1.8151928)):
        np.testing.assert_allclose(rows[l][0], pin, rtol=1e-4)
    _, out = run_main("parelagmc_tpu_torch.examples", "likelihood_example", args, capsys)
    vals = {int(l.split("=")[1].split(":")[0]): float(l.split(":")[1])
            for l in out.splitlines() if l.startswith("L = ")}
    assert sorted(vals) == [0, 1, 2]
    for l, pin in ((0, 0.92472297), (1, 0.92566917), (2, 0.92746946)):
        np.testing.assert_allclose(vals[l], pin, rtol=1e-4)


def _darcy_rows(out):
    rows = [l.split() for l in out.splitlines()]
    return {int(r[0]): (int(r[2]), float(r[3])) for r in rows if len(r) == 4 and r[0].isdigit()}


def test_darcy_test_refinements_1(capsys):
    """Tier-1 case of the slow golden run below: Q = 2 (k = 1) on each level."""
    _, out = run_main("parelagmc_tpu_torch.examples", "darcy_test", ["--refinements", "1"], capsys)
    rows = _darcy_rows(out)
    assert [rows[l][0] for l in (0, 1)] == [2240, 304]
    for _, q in rows.values():
        np.testing.assert_allclose(q, 2.0, rtol=1e-5)


@pytest.mark.slow
def test_darcy_test_golden(capsys):
    """tests/test_examples.py::test_darcy_test_golden against the original."""
    _, out = run_both("darcy_test", ["--refinements", "2"], capsys, 1e-4)
    rows = _darcy_rows(out)
    assert [rows[l][0] for l in (0, 1, 2)] == [17152, 2240, 304]
    for _, q in rows.values():
        np.testing.assert_allclose(q, 2.0, rtol=1e-5)


def _golden_estimate(common, problems, uq, argv):
    cfg = common.parse_config(argv)
    prob = problems.build_problem(cfg, device=CPU) if common is tcommon else \
        problems.build_problem(cfg)
    mgr = uq.MLMCManager(prob.solver, prob.sampler, cfg)
    est = mgr.run()
    mgr.close()
    return est, mgr


def test_golden_estimate_refinements_1(tmp_path, monkeypatch):
    """Tier-1 case of the slow golden estimate below: the same adaptive run
    at refinements 1 under the dof cost model (the walltime one allocates
    by this host's timings), the twin's estimate and samples equal to the
    original's."""
    import parelagmc_tpu.problems as jproblems
    import parelagmc_tpu.uq as juq
    import parelagmc_tpu_torch.problems as tproblems
    import parelagmc_tpu_torch.uq as tuq

    monkeypatch.chdir(tmp_path)
    argv = ["--refinements", "1", "--dtype", "float64", "--seed", "0", "--mse", "0.002",
            "--samples", "32", "--batch", "32", "--output", ""] + DEEP
    for common in (jcommon, tcommon):
        monkeypatch.setattr(common, "ProblemConfig",
                            lambda *a, _c=common.ProblemConfig, **k: _c(*a, cost_model="dofs", **k))
    ref, jmgr = _golden_estimate(jcommon, jproblems, juq, argv)
    est, mgr = _golden_estimate(tcommon, tproblems, tuq, argv)
    np.testing.assert_allclose(est, ref, rtol=1e-6)
    assert mgr.level_nsamples.tolist() == jmgr.level_nsamples.tolist()
    assert mgr.ml_estimator_variance <= mgr.ratio * mgr.eps2


@pytest.mark.slow
def test_golden_estimate(tmp_path, monkeypatch):
    """tests/test_examples.py::test_mlmc_golden_estimate on the twin: the
    estimate within the error model's band of the reference's 2.5599."""
    import parelagmc_tpu_torch.problems as tproblems
    import parelagmc_tpu_torch.uq as tuq

    monkeypatch.chdir(tmp_path)
    est, mgr = _golden_estimate(tcommon, tproblems, tuq, [
        "--refinements", "2", "--dtype", "float64", "--seed", "0", "--mse", "0.002",
        "--samples", "32", "--batch", "32"])
    assert mgr.ml_estimator_variance <= mgr.ratio * mgr.eps2
    ref_sigma_bound = np.sqrt(0.5 * 1e-3)
    band = 3.0 * np.sqrt(mgr.ml_estimator_variance) + 3.0 * ref_sigma_bound
    band_limit = 3.0 * np.sqrt(mgr.ratio * mgr.eps2) + 3.0 * ref_sigma_bound
    assert band <= band_limit + 1e-12, (band, mgr.ml_estimator_variance)
    assert abs(est - 2.5599) < band, (est, band)


def test_ratio_estimator_mlmc_pin(capsys, tmp_path, monkeypatch):
    """Tier-1 case of the slow comparison below: the twin alone at
    tests/test_examples.py's settings holds its pin."""
    monkeypatch.chdir(tmp_path)
    est, out = run_main("parelagmc_tpu_torch.examples", "ratio_estimator_mlmc",
                        SMALL + ["--splitting"], capsys)
    assert "Splitting Estimate" in out
    np.testing.assert_allclose(est, 2.29769, atol=0.02)


@pytest.mark.slow
def test_ratio_estimator_mlmc(capsys, tmp_path, monkeypatch):
    """tests/test_examples.py::test_ratio_estimator_mlmc against the original."""
    monkeypatch.chdir(tmp_path)
    est, out = run_both("ratio_estimator_mlmc", SMALL + ["--splitting"], capsys, 1e-4)
    assert "Splitting Estimate" in out
    np.testing.assert_allclose(est, 2.29769, atol=0.02)


SAMPLER_TEST = ["--refinements", "1", "--batch", "16", "--samples", "8", "--corlen", "0.4"]


def test_sampler_test_pin(capsys):
    """Tier-1 case of the slow comparison below: the twin alone at
    tests/test_examples.py's settings prints every sampler's rows."""
    _, out = run_main("parelagmc_tpu_torch.examples", "sampler_test", SAMPLER_TEST, capsys)
    for name in ("analytic-KLE", "matern-KLE", "SPDE ", "SPDE-embedded", "SPDE-projection"):
        assert sum(l.startswith(name) for l in out.splitlines()) == 2, name
    assert "80 samples" in out


@pytest.mark.slow
def test_sampler_test_driver(capsys):
    """tests/test_examples.py::test_sampler_test_driver against the original."""
    _, out = run_both("sampler_test", SAMPLER_TEST, capsys, 1e-4)
    assert "SPDE-projection" in out


def test_realization_test_writes_the_originals_files(tmp_path, monkeypatch, capsys):
    """The files of each level: the meshes byte for byte, the fields number
    for number (float64 draws, written with 10 digits)."""
    argv = ["--refinements", "1", "--dtype", "float64"]
    files = {}
    for pkg in ("examples", "parelagmc_tpu_torch.examples"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        _, out = run_main(pkg, "realization_test", argv, capsys)
        files[pkg] = {p.name: p.read_text() for p in sorted(d.iterdir())}
        assert "level 1: saved realization" in out
    mine, ref = files["parelagmc_tpu_torch.examples"], files["examples"]
    expect = {f"realization{part}_L0{l}.{ext}" for l in (0, 1)
              for part, ext in (("", "vtk"), ("", "gf"), ("_mesh", "mesh"))}
    assert set(mine) == set(ref) == expect
    for name in ref:
        if name.endswith(".mesh"):
            assert mine[name] == ref[name]
        else:
            assert "RECTILINEAR_GRID" in ref[name] or "FiniteElementSpace" in ref[name]
            assert_same_output(mine[name], ref[name], 1e-9)


def _tet_files(tmp_path):
    """A tet cube (2^3 hexes in six tets each) and its non-matching
    enlargement, as MFEM files: cube.mesh and cube_enlarge.mesh."""
    from parelagmc_tpu_torch.mesh import mfem_io

    gm = general_mesh(mfem_io, (2, 2, 2))
    gm.boundary_attributes[:] = 1
    write_general_mesh(tmp_path / "cube.mesh", gm)
    write_general_mesh(tmp_path / "cube_enlarge.mesh",
                       general_mesh(mfem_io, (3, 3, 3), lengths=(1.5,) * 3, label=False,
                                    origin=(-0.25,) * 3))
    return str(tmp_path / "cube.mesh")


def test_realization_test_velocity_transfer(tmp_path, monkeypatch, capsys):
    """--velocity-transfer on a tet mesh file with the projection embedding:
    the RT0 transfer of a constant velocity, each level's line as the
    original's (constants reproduced to rounding)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--mesh", _tet_files(tmp_path), "--embedding", "projection", "--refinements", "1",
            "--velocity-transfer"] + F64
    ref_result, ref = run_main("examples", "realization_test", argv, capsys)
    _, out = run_main("parelagmc_tpu_torch.examples", "realization_test", argv, capsys)
    lines = [l for l in out.splitlines() if "velocity transfer" in l]
    assert len(lines) == 2 and len(ref.splitlines()) == 2
    for a, b in zip(lines, ref.splitlines()):
        assert a.split("constant-field")[0] == b.split("constant-field")[0]
        err, ref_err = float(a.split()[-1]), float(b.split()[-1])
        assert err < 1e-7 and abs(err - ref_err) <= 1e-3 * ref_err
    with pytest.raises(SystemExit, match="requires the non-matching projection"):
        _module("parelagmc_tpu_torch.examples", "realization_test").main(
            ["--refinements", "1", "--velocity-transfer", "--device", "cpu"])


def test_mlmc_on_a_mesh_file(tmp_path, monkeypatch, capsys):
    """The mlmc driver on a generated tet mesh file (tests/test_examples.py's
    mesh-file run reads the reference's cube_tet.mesh, absent here)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--mesh", _tet_files(tmp_path), "--refinements", "1", "--batch", "8", "--samples",
            "8", "--mse", "1e10", "--variance", "0.25"] + F64 + DEEP
    run_both("mlmc", argv, capsys, 1e-6)


# -- how the drivers start -----------------------------------------------------------


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def test_launch_from_the_command_line(tmp_path):
    """`python -m parelagmc_tpu_torch.examples.mlmc --device cpu ...` exits
    0 and prints FINAL MLMC ERRORS, with neither jax nor the JAX package
    loaded (checked in a run through runpy, as -m runs it)."""
    args = ["--device", "cpu"] + SMALL
    out = subprocess.run([sys.executable, "-m", "parelagmc_tpu_torch.examples.mlmc"] + args,
                         cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FINAL MLMC ERRORS" in out.stdout
    code = ("import runpy, sys\n"
            f"sys.argv = ['mlmc'] + {args!r}\n"
            "runpy.run_module('parelagmc_tpu_torch.examples.mlmc', run_name='__main__',"
            " alter_sys=True)\n"
            "print('LOADED', any(k == 'jax' or k.startswith('jax.') for k in sys.modules),"
            " any(k == 'parelagmc_tpu' or k.startswith('parelagmc_tpu.') for k in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FINAL MLMC ERRORS" in out.stdout
    assert out.stdout.splitlines()[-1] == "LOADED False False"


@pytest.mark.parametrize("name", DRIVERS)
def test_no_fallback_to_the_cpu(name, tmp_path, monkeypatch):
    """Without a card, main() with no --device raises before any work; it
    never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    monkeypatch.chdir(tmp_path)
    argv = ["--refinements", "1"] + (["--grid", "8,12,4"] if name.startswith("spe10") else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _module("parelagmc_tpu_torch.examples", name).main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("argv,error,match", [
    (["--spatial-shards", "2"], NotImplementedError, "item 14b"),
    (["--dtype", "bfloat16"], NotImplementedError, "not supported"),
    (["--sample-shards", "2"], ValueError, "sample_shards=2"),
])
def test_unported_options_raise(argv, error, match, tmp_path, monkeypatch):
    """--dtype bfloat16 reaches the port's dtype refusal and two sample
    shards on the CPU's one device the config rule's ValueError: nothing
    runs something else instead. --spatial-shards 2, refused until ROADMAP
    item 14b was ported, now runs: its MLMC estimate (float64, the small
    settings whose first round meets the target, so no timing can change
    the sample counts) equals the unsharded run's."""
    monkeypatch.chdir(tmp_path)
    if argv == ["--spatial-shards", "2"]:
        mlmc = _module("parelagmc_tpu_torch.examples", "mlmc")
        small = SMALL + ["--dtype", "float64", "--device", "cpu", "--solver-opt",
                         "relative_tolerance=1e-10"]
        est = mlmc.main(small + argv)
        assert math.isfinite(est)
        np.testing.assert_allclose(est, mlmc.main(small), rtol=1e-8)
        return
    with pytest.raises(error, match=match):
        _module("parelagmc_tpu_torch.examples", "mlmc").main(
            ["--refinements", "1", "--device", "cpu"] + argv)
