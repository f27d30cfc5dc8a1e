"""The port's SPE10 evidence and tuning drivers (parelagmc_tpu_torch/
examples/spe10_{performance,adjoint_check,beta_noise,mg_tuning,
rate_diagnostics}.py) against the JAX package's examples/ on the CPU.

Each runs the JAX driver and its twin in process, at a small size, from the
same command line and seed (the twin with its CPU flag), and compares what
is deterministic: dofs, batches, iteration counts (2 or 2 %, as CG parts
by rounding), converged fractions, QoIs and their statistics (float64 with
deep solves: 1e-8 relative; the error of a loose solve against the truth,
itself a relative number, to 1e-8 absolute). Timings are never compared.

The drivers time best-of rounds, and each round solves other samples (its
own keys) or fields: which round is kept decides which iterations are
reported. Each driver module's `time` is replaced by a clock that advances
one second a call, so every round takes the same time and both packages
keep the first.

The JAX drivers set jax's platform and x64 inside main; this process runs
jax on the CPU with x64 already (tests/conftest.py), so the flags are passed
and the updates are no-ops. spe10_performance hard-codes the 60x220x85
grid, and spe10_adjoint_check takes its full-grid branch there: their tests
patch, in both packages, the grid constant that mesh="spe10" reads and the
load_spe10_kinv each driver calls, to a small grid.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread count)
from _torch_parity import close_iterations, drivers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TWINS = "parelagmc_tpu_torch.examples"
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
Q_RTOL = 1e-8
ERR_ATOL = 1e-8


def assert_close(a, b, rtol=Q_RTOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


# -- spe10_performance ---------------------------------------------------------------

PERF_GRID = (8, 16, 8)
PERF_ARGV = ["--batch", "4", "--samples", "8", "--batch-clamp", "4", "--dtype", "float64",
             "--selfcheck", "--solver-opt", "relative_tolerance=1e-10"]


def _small_spe10(monkeypatch, jmod, tmod, grid=PERF_GRID):
    """SPE10's grid cut to `grid` in both packages: the constant mesh="spe10"
    reads, and the load_spe10_kinv each driver calls (a name of its module,
    or, where the driver imports it inside main, of physics.spe10)."""
    import parelagmc_tpu.physics.spe10 as jspe10
    import parelagmc_tpu.problems as jproblems
    import parelagmc_tpu_torch.problems as tproblems

    if not hasattr(jmod, "load_spe10_kinv"):
        jmod = jspe10
    for problems, mod in ((jproblems, jmod), (tproblems, tmod)):
        monkeypatch.setattr(problems, "SPE10_NCELLS", grid)
        real = mod.load_spe10_kinv
        monkeypatch.setattr(mod, "load_spe10_kinv",
                            lambda perm, ncells, _real=real: _real(perm, ncells=grid))


def _record_sample_eval(monkeypatch, jmod):
    """The field mean of each level's warm-up Sample+Eval call of the JAX
    driver (its first call), in level order."""
    means, real = [], jmod.jit_hoisted

    def jit_hoisted(f, *args, **kw):
        g = real(f, *args, **kw)
        if f.__name__ != "sample_eval":
            return g
        calls = []

        def h(*a):
            out = g(*a)
            if not calls:
                means.append(float(np.mean(np.asarray(out[0], np.float64))))
            calls.append(1)
            return out

        return h

    monkeypatch.setattr(jmod, "jit_hoisted", jit_hoisted)
    return means


def test_spe10_performance_matches_the_original(tmp_path, monkeypatch, capsys):
    jmod, tmod = drivers(monkeypatch, "spe10_performance")
    _small_spe10(monkeypatch, jmod, tmod)
    means = _record_sample_eval(monkeypatch, jmod)
    ref = jmod.main(PERF_ARGV + ["--out", str(tmp_path / "ref.json")])
    ev = tmod.main(PERF_ARGV + ["--out", str(tmp_path / "ev.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("ok") >= 6  # both selfchecks: three checks each
    assert json.loads((tmp_path / "ev.json").read_text()) == json.loads(json.dumps(ev))
    assert ev["device"] == "cpu" and ev["config"] == ref["config"]
    assert len(ev["levels"]) == len(ref["levels"]) == len(means) == 3
    for row, rrow, mean in zip(ev["levels"], ref["levels"], means):
        for k in ("level", "stoch_dofs", "darcy_dofs", "darcy_nnz", "batch"):
            assert row[k] == rrow[k], (k, row, rrow)
        assert_close(row["sample_eval"]["field_mean"], mean)
        assert row["sample_eval"]["mean_iterations"] == rrow["sample_eval"]["mean_iterations"] == 0
        mine, theirs = row["mlmc_pair"], rrow["mlmc_pair"]
        assert mine["converged_fraction"] == theirs["converged_fraction"] == 1.0
        assert close_iterations(mine["mean_iterations"], theirs["mean_iterations"]), (mine, theirs)
        assert set(mine) == set(theirs)


# -- spe10_adjoint_check -------------------------------------------------------------

ADJ_ARGV = ["--platform", "cpu", "--grid", "8,16,6", "--batch", "2"]


def test_spe10_adjoint_check_matches_the_original(tmp_path, monkeypatch, capsys):
    jmod, tmod = drivers(monkeypatch, "spe10_adjoint_check")
    monkeypatch.setattr(sys, "argv", ["spe10_adjoint_check.py"] + ADJ_ARGV
                        + ["--out", str(tmp_path / "ref.json")])
    jmod.main()
    assert tmod.main(ADJ_ARGV + ["--out", str(tmp_path / "ev.json")]) is None
    ref = json.loads((tmp_path / "ref.json").read_text())
    ev = json.loads((tmp_path / "ev.json").read_text())
    assert ev["device"] == "cpu" and ev["config"]["platform"] == ref["config"]["platform"]
    assert ev["config"]["grid"] == ref["config"]["grid"] and ev["config"]["rtols"] == ref[
        "config"]["rtols"]
    for leg in ("plain", "adjoint", "truth"):
        assert ev[leg]["converged"] is ref[leg]["converged"] is True
        assert close_iterations(ev[leg]["iterations"], ref[leg]["iterations"]), leg
    for leg in ("plain", "adjoint"):
        assert ev[leg]["segments"] == ref[leg]["segments"]
        for k in ("max_rel_Y_error", "max_rel_Q_error"):
            assert abs(ev[leg][k] - ref[leg][k]) <= ERR_ATOL, (leg, k, ev[leg][k], ref[leg][k])
    # The adjoint correction: tighter Y than the plain leg at a looser rtol.
    assert ev["adjoint"]["max_rel_Y_error"] < ev["plain"]["max_rel_Y_error"]
    assert_close(ev["truth"]["E_Y"], ref["truth"]["E_Y"])
    assert "max rel Y err" in capsys.readouterr().out


# The full grid's branch (mesh "spe10", three levels coarsened from the fine
# grid, the largest axis moved to x by axis_order "auto"), with SPE10's
# 60x220x85 cut to a grid of the same parities.
ADJ_SPE10_GRID = (6, 22, 9)


def test_spe10_adjoint_check_full_grid_branch_matches_the_original(tmp_path, monkeypatch):
    jmod, tmod = drivers(monkeypatch, "spe10_adjoint_check")
    _small_spe10(monkeypatch, jmod, tmod, ADJ_SPE10_GRID)
    argv = ["--platform", "cpu", "--batch", "2", "--plain-rtol", "1e-6", "--truth-rtol", "1e-6"]
    monkeypatch.setattr(sys, "argv", ["spe10_adjoint_check.py"] + argv
                        + ["--out", str(tmp_path / "ref.json")])
    jmod.main()
    tmod.main(argv + ["--out", str(tmp_path / "ev.json")])
    ref = json.loads((tmp_path / "ref.json").read_text())
    ev = json.loads((tmp_path / "ev.json").read_text())
    assert ev["config"]["grid"] == ref["config"]["grid"] == [60, 220, 85]
    for leg in ("plain", "adjoint", "truth"):
        assert ev[leg]["converged"] is ref[leg]["converged"] is True
        assert close_iterations(ev[leg]["iterations"], ref[leg]["iterations"]), leg
    for leg in ("plain", "adjoint"):
        for k in ("max_rel_Y_error", "max_rel_Q_error"):
            assert abs(ev[leg][k] - ref[leg][k]) <= ERR_ATOL, (leg, k, ev[leg][k], ref[leg][k])
    assert_close(ev["truth"]["E_Y"], ref["truth"]["E_Y"])


# -- spe10_beta_noise ----------------------------------------------------------------

BETA_ARGV = ["--cpu-f64", "--grid", "8,16,8", "--samples", "8", "--batch", "4"]


def test_spe10_beta_noise_matches_the_original(tmp_path, monkeypatch):
    jmod, tmod = drivers(monkeypatch, "spe10_beta_noise")
    for sub in ("ref", "ev"):
        (tmp_path / sub).mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    ref = jmod.main(list(BETA_ARGV))
    monkeypatch.chdir(tmp_path / "ev")
    ev = tmod.main(list(BETA_ARGV))
    assert sorted(os.listdir(tmp_path / "ev")) == [
        "SPE10_BETA_NOISE_F64_TORCH.json", "beta_deep.dat", "beta_prod.dat"]
    assert json.loads((tmp_path / "ev" / "SPE10_BETA_NOISE_F64_TORCH.json").read_text()) == ev
    assert ev.pop("device") == "cpu"
    assert set(ev) == set(ref) and "beta_prod" in ev and len(ev["levels"]) == 3
    for k in ("samples_per_level", "deep_rtol", "cpu_f64", "M_pair_levels"):
        assert ev[k] == ref[k], k
    for k in ("beta_prod", "beta_deep"):
        assert_close(ev[k], ref[k])
    for lv, rlv in zip(ev["levels"], ref["levels"]):
        assert lv["level"] == rlv["level"] and lv["n"] == rlv["n"] == 8
        for k in ("mean_iters_prod", "mean_iters_deep"):
            assert close_iterations(lv[k], rlv[k]), (k, lv, rlv)
        for k in ("var_Y_prod", "var_Y_deep", "mean_Y_prod", "mean_Y_deep", "corr"):
            assert_close(lv[k], rlv[k])
        # The paired noise is the difference of two logged columns.
        for k in ("var_noise", "noise_fraction_of_var", "max_abs_dY"):
            np.testing.assert_allclose(lv[k], rlv[k], rtol=1e-6, atol=1e-12)


# -- spe10_mg_tuning -------------------------------------------------------------------

MG_GRID = ["--grid", "16,32,16"]


def _mg_rows(monkeypatch, argv):
    jmod, tmod = drivers(monkeypatch, "spe10_mg_tuning")
    ref = jmod.main(list(argv))
    rows = tmod.main(list(argv) + ["--platform", "cpu"])
    assert [r["label"] for r in rows] == [r["label"] for r in ref]
    for row, rrow in zip(rows, ref):
        assert row["converged"] is rrow["converged"] is True
        assert close_iterations(row["iters"], rrow["iters"]), (row, rrow)
        assert row["s_applies"] == rrow["s_applies"] and row["overrides"] == rrow["overrides"]
        assert_close(row["q0"], rrow["q0"])
        # The proxy's components, measured on this device, are in every row.
        assert {"t_schur", "t_ovh", "t_apply"} <= set(row) and row["t_apply"] > 0
    return rows


def test_spe10_mg_tuning_quick_matches_the_original(monkeypatch):
    rows = _mg_rows(monkeypatch, MG_GRID + ["--quick", "--rtol", "1e-8"])
    assert len(rows) == 3


@pytest.mark.slow
def test_spe10_mg_tuning_matches_the_original(monkeypatch):
    rows = _mg_rows(monkeypatch, MG_GRID + ["--rtol", "1e-8"])
    assert len(rows) == 14


# -- spe10_rate_diagnostics ------------------------------------------------------------

RATE_ARGV = ["--grid", "8,16,8", "--n", "16", "--nlevels", "2"]


def test_spe10_rate_diagnostics_prints_the_originals_lines(capsys):
    """The printed lines number by number: the text between the numbers
    equal, the iteration counts within 2, every other number within 1e-8
    relative (printed at 4 digits, so equal unless at a rounding edge)."""
    jmod = importlib.import_module("examples.spe10_rate_diagnostics")
    tmod = importlib.import_module(f"{TWINS}.spe10_rate_diagnostics")
    capsys.readouterr()
    jmod.main(list(RATE_ARGV))
    ref = capsys.readouterr().out.splitlines()
    assert tmod.main(RATE_ARGV + ["--cpu"]) is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(ref) == 10
    for a, b in zip(out, ref):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        x = np.array([float(v) for v in NUMBER.findall(a)])
        y = np.array([float(v) for v in NUMBER.findall(b)])
        if "iters f/c/x" in a:
            assert np.abs(x - y).max() <= 2, (a, b)
        else:
            np.testing.assert_allclose(x, y, rtol=Q_RTOL, atol=0, err_msg=f"{a}\n{b}")
    assert "converged True/True/True" in out[2]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def test_rate_diagnostics_launches_without_jax(tmp_path):
    """`python -m parelagmc_tpu_torch.examples.spe10_rate_diagnostics --cpu`
    runs to its end with neither jax, the JAX package nor the root examples
    package loaded (checked in a run through runpy, as -m runs it)."""
    args = RATE_ARGV + ["--cpu"]
    out = subprocess.run([sys.executable, "-m", f"{TWINS}.spe10_rate_diagnostics"] + args,
                         cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "(discretization+upscaling)" in out.stdout
    code = ("import runpy, sys\n"
            f"sys.argv = ['spe10_rate_diagnostics'] + {args!r}\n"
            f"runpy.run_module('{TWINS}.spe10_rate_diagnostics', run_name='__main__',"
            " alter_sys=True)\n"
            "print('LOADED', sorted(k for k in sys.modules"
            " if k.split('.')[0] in ('jax', 'parelagmc_tpu', 'examples')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "LOADED []"


# -- every twin: no fallback to the CPU --------------------------------------------------

NO_DEVICE_ARGV = {
    "spe10_performance": [],
    "spe10_adjoint_check": ["--grid", "8,16,6", "--batch", "2"],
    "spe10_beta_noise": ["--grid", "8,16,8", "--samples", "8"],
    "spe10_mg_tuning": ["--grid", "8,16,8", "--quick"],
    "spe10_rate_diagnostics": ["--grid", "8,16,8", "--n", "16"],
    "spe10_sampler_performance": ["--grid", "8,16,8", "--refinements", "1"],
    "unstructured_performance": ["--mesh", "cube.mesh", "--refine", "1"],
    "spe10_level0_breakdown": ["--grid", "12,44,16", "--batch", "2"],
    "spe10_struct_profile": ["--grid", "12,44,16", "--batch", "2"],
    "spe10_vcycle_profile": ["--batch", "2"],
    "spe10_iter_cost": ["--batch", "2", "--lo", "2", "--hi", "4"],
    "spe10_level1_cost": ["--batches", "1"],
    "spe10_layout_probe": ["--smoke"],
}


@pytest.mark.parametrize("name", list(NO_DEVICE_ARGV))
def test_no_fallback_to_the_cpu(name, tmp_path, monkeypatch):
    """Without a card, each twin run without its CPU flag or --device raises
    before any work and writes nothing; it never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"{TWINS}.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(list(NO_DEVICE_ARGV[name]))
    assert not any(tmp_path.iterdir())
