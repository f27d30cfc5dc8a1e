"""Abstract multilevel sampler contract (port of
parelagmc_tpu/samplers/base.py): a sampler draws batches of white noise
per level (`sample`) and maps noise to realizations on a target level
(`eval`), where the noise may live on a finer level than the field (the
MLMC coupling)."""

from __future__ import annotations

import abc
from typing import Optional

import torch

from parelagmc_tpu_torch.ops.prng import Key


class MLSampler(abc.ABC):
    @abc.abstractmethod
    def sample_size(self, level: int) -> int:
        """Noise vector length at `level`."""

    @abc.abstractmethod
    def field_size(self, level: int) -> int:
        """Realization (cell field) length at `level`."""

    @abc.abstractmethod
    def sample(self, level: int, key: Key, nsamples: int) -> torch.Tensor:
        """Draw (nsamples, sample_size(level)) white noise."""

    @abc.abstractmethod
    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        """Map noise sampled at `xi_level` (default `level`, xi_level <=
        level) to realizations on `level`."""

    def nnz(self, level: int) -> int:
        """Operator size metric for the dashboards."""
        return 0
