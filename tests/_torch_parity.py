"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Each test builds its inputs from a seed with numpy, runs them through the
JAX package (on the CPU, float64 unless stated) and through its
counterpart in parelagmc_tpu_torch, and compares with a stated tolerance.
Tests that need a CUDA card take the `cuda_device` fixture, which skips
when there is none; the decision is made inside the fixture, never at
collection, so every pytest-xdist worker collects the same tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# Several pytest-xdist workers share the host: keep each one's intra-op pool small.
torch.set_num_threads(2)

# The port's entry points run on cuda:0 unless asked otherwise; the CPU
# parity tests ask for the CPU through this constant.
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def to_np(x) -> np.ndarray:
    """numpy copy of a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over all entries."""
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def port_config(cfg):
    """The port's own config (parelagmc_tpu_torch.config) with the field
    values of a JAX-package config, nested configs recursed into: the tests
    build one config and hand each package its own class."""
    from parelagmc_tpu_torch import config as tconfig

    cls = getattr(tconfig, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)
