"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Each test builds its inputs from a seed with numpy, runs them through the
JAX package (on the CPU, float64 unless stated) and through its
counterpart in parelagmc_tpu_torch, and compares with a stated tolerance.
Tests that need a CUDA card take the `cuda_device` fixture, which skips
when there is none; the decision is made inside the fixture, never at
collection, so every pytest-xdist worker collects the same tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# Several pytest-xdist workers share the host: keep each one's intra-op pool small.
torch.set_num_threads(2)


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
