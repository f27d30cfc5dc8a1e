"""The port stands without jax, builds nothing at import, and refuses what
it has not ported instead of running something else."""

import os
import re
import subprocess
import sys

import pytest
import torch

import _torch_parity  # noqa: F401  (thread count)
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device, torch_dtype
from parelagmc_tpu_torch.problems import build_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "parelagmc_tpu_torch")
MODULES = [
    "parelagmc_tpu_torch",
    "parelagmc_tpu_torch.convert",
    "parelagmc_tpu_torch.device",
    "parelagmc_tpu_torch.kernels",
    "parelagmc_tpu_torch.ops.coef_multigrid_structured",
    "parelagmc_tpu_torch.ops.mass_solve",
    "parelagmc_tpu_torch.ops.prng",
    "parelagmc_tpu_torch.ops.solvers",
    "parelagmc_tpu_torch.ops.tensorsolve",
    "parelagmc_tpu_torch.ops.tridiag_pallas",
    "parelagmc_tpu_torch.physics.darcy",
    "parelagmc_tpu_torch.physics.spe10",
    "parelagmc_tpu_torch.problems",
    "parelagmc_tpu_torch.samplers.pde",
    "parelagmc_tpu_torch.uq.managers",
    "parelagmc_tpu_torch.utils.timing",
]


def test_port_imports_leave_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('jax' in sys.modules, any(k.startswith('jax.') for k in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_no_jax_import_in_package_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_kernel_sources_ship_with_the_package():
    from parelagmc_tpu_torch import kernels

    for name in kernels.SOURCES:
        assert os.path.isfile(os.path.join(kernels.CSRC_DIR, name))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_device_and_dtype_helpers():
    assert torch_dtype("float32") is torch.float32
    assert torch_dtype(torch.float64) is torch.float64
    with pytest.raises(NotImplementedError):
        torch_dtype("bfloat16")
    assert resolve_device(None) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


@pytest.mark.parametrize(
    "field,value",
    [("mesh", "egg"), ("embedding", "matching"), ("sampler_name", "matern"),
     ("mesh", "cube.mesh"), ("dtype", "bfloat16")],
)
def test_build_problem_refuses_unported_configs(field, value):
    cfg = ProblemConfig(refinements=0, **{field: value})
    with pytest.raises(NotImplementedError):
        build_problem(cfg)
