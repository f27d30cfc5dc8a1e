"""Nothing of JAX or the JAX package in a run; nothing of the port in the
reference."""

import os
import shutil
import subprocess
import sys
import types

import harness

BENCH = harness.HERE


def test_forbidden_names_are_compared_whole():
    mods = {"parelagmc_tpu_torch": types.ModuleType("x"),
            "parelagmc_tpu_torch.ops": types.ModuleType("x"), "numpy": types.ModuleType("x")}
    assert harness.forbidden_loaded(mods) == []
    mods["parelagmc_tpu"] = types.ModuleType("parelagmc_tpu")
    mods["jax.numpy"] = types.ModuleType("jax.numpy")
    assert harness.forbidden_loaded(mods) == ["jax.numpy", "parelagmc_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.problem, reference.krylov, reference.galerkin, reference.threefry\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('parelagmc_tpu_torch', 'parelagmc_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad); sys.exit(1 if bad else 0)" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_fails_without_the_port_or_a_card(tmp_path):
    """In a directory of BENCHMARK.json and benchmark/ alone (and on a host
    without a card) a run exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "spe10-l0-pair", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=env,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")
