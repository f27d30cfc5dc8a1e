"""Whole runs on the CPU (the look for a card skipped), in a copy of the
benchmark to which a test cell is added from new files alone: it runs
and is correct; the same run with the timed path broken underneath
(benchmark/faults.py) is not; and the controls fail the SPE10 cells'
limits."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import drive
import faults
import harness
import verify
from reference import problem as rp, threefry
from reference.mixed import Precision

DRIVER = """
import sys
sys.path.insert(0, 'benchmark')
import faults, run

name = None if sys.argv[1] == 'none' else sys.argv[1]
patch = lambda prob: faults.install(prob, lambda: name, rel=1e-3)
sys.exit(run.main(sys.argv[2:], need_card=False, patch=patch))
"""

# A 4 x 4 x 4 box in two levels, float32, cg-schur: the test cell's
# configuration.
TINY = {
    "name": "tiny",
    "problem": {"mesh": "box", "ncells": [2, 2, 2], "lengths": [2.0, 2.0, 2.0],
                "refinements": 1, "sampler_name": "pde", "correlation_length": 0.1,
                "variance": 1.0, "lognormal": True, "qoi": "eff_perm",
                "ess_attr": [0, 1, 1, 1, 1, 0], "obs_attr": [1, 0, 0, 0, 0, 0],
                "inflow_attr": [0, 0, 0, 0, 0, 1], "batch_size": 8, "dtype": "float32",
                "cost_model": "dofs",
                "darcy_solver": {"name": "cg-schur", "max_iterations": 500,
                                 "relative_tolerance": 1e-06}},
    "reduced": [],
}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """The benchmark with a test configuration, mix, limits and metric
    added as new files, and new entries in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = harness.load_benchmark()
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (root / "benchmark" / "traffic" / "tiny_pairs.json").write_text(json.dumps(
        {"kind": "level_steps", "level": 0, "batch": 8, "profile_units": 2,
         "check": {"batches": 3, "rows": 4}}))
    limits = {"field_gap": 1e-5, "q_mean_gap": 1e-4, "key_miss": 0, "sum_gap": 1e-9,
              "nonfinite": 0}
    (root / "benchmark" / "limits" / "tiny-pair.json").write_text(json.dumps(limits))
    (root / "benchmark" / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(run.batches())\n")
    b["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-pair", "config": "tiny", "traffic": "tiny_pairs",
                           "chips": 1, "why": "t"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "spe10-l0-pair" in m.get("workloads", []):
            m["workloads"].append("tiny-pair")
    b["per_layer"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                           "source": "program_counter", "layer": "manager (uq/managers)",
                           "moves": "samples_per_s", "workloads": ["tiny-pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "drive_cpu.py").write_text(DRIVER)
    return root


def run_cell(root, fault, cell, seed, trace=0):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "drive_cpu.py", fault, "--workload", cell, "--seed",
                          str(seed), "--seconds", "1.5", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_added_cell_runs_and_is_correct(copy):
    res, err = run_cell(copy, "none", "tiny-pair", 2 ** 31 + 11)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"samples_per_s", "batch_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks" and "field_gap" in err.splitlines()[-5]
    assert 0.0 < res["checks"]["field_gap"][0] < 1e-5
    traced, _ = run_cell(copy, "none", "tiny-pair", 5, trace=1)
    assert traced["correct"] and traced["metrics"]["batches_seen"]["value"] > 0
    assert "darcy_ms.rate" in traced["metrics"] and "samples_per_s" not in traced["metrics"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(copy, fault):
    res, err = run_cell(copy, fault, "tiny-pair", 12345)
    assert res["correct"] is False, err[-2000:]


def test_the_controls_fail_the_cells_limits(monkeypatch):
    """The controls in the program's place, on a small SPE10-shaped grid:
    the reference in TF32 reads a field gap above every SPE10 cell's
    field_gap limit, and the reference's CG in bfloat16 a mean Q gap
    above every q_mean_gap limit."""
    cells = (10, 18, 7)
    monkeypatch.setattr(rp, "SPE10_CELLS", cells)
    spec = harness.load_json(os.path.join(harness.HERE, "configs", "spe10.json"))
    perm = dict(spec["permeability"], ncells=list(cells))
    ref = rp.ReferenceProblem(spec, kinv=drive.permeability({"permeability": perm}))
    limits = [harness.load_json(os.path.join(harness.HERE, "limits", w["name"] + ".json"))
              for w in harness.load_benchmark()["workloads"]]
    exact, bf16 = verify.solver_for("cpu"), verify.solver_for("cpu", storage="bfloat16")
    for seed in (1, 2, 3):
        field, q = [], []
        for level in (0, 1):
            key = threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), level), 1)
            for lv in (level, level + 1):
                w = ref.coefficients(key, 8, list(range(8)), level, lv, Precision())
                w_tf32 = ref.coefficients(key, 8, list(range(8)), level, lv, Precision("tf32"))
                field.append(np.max(np.abs(w_tf32 - w) / w))
                want = np.asarray(exact(ref.darcy[lv], w))
                q.append(np.abs(np.asarray(bf16(ref.darcy[lv], w)) - want) / np.abs(want))
        assert all(max(field) > lim["field_gap"] for lim in limits), field
        assert all(np.mean(np.concatenate(q)) > lim["q_mean_gap"] for lim in limits)
