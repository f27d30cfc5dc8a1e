"""Truncated Karhunen-Loeve expansion sampler.

Port of parelagmc_tpu/samplers/kl.py (reference: ParELAGMC
src/KLSampler.cpp): given covariance eigenpairs (theta_k, b_k) on the
finest level, a realization is

    s(level) = sum_k sqrt(theta_k) * b_k(level) * xi_k,    xi ~ N(0, sigma^2),

with the eigenvectors carried to coarser levels on the host by the P0
cochain projector (volume-weighted averaging over the parent cells,
Pi = W_c^{-1} P_l2^T W_f), and exp() for log-normal fields.

On the device the evaluation is one dense matmul (batch, modes) x (modes,
n) per level: `torch.matmul`, which needs full float32 products (on the
card the caller keeps TF32 off, PyTorch's default). MLMC coupling needs no
restriction: fine and coarse realizations share the mode coefficients xi.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.fem.hierarchy import GeometricHierarchy
from parelagmc_tpu_torch.ops.prng import Key, sample_normals
from parelagmc_tpu_torch.samplers.base import MLSampler
from parelagmc_tpu_torch.samplers.covariance import CovarianceFunction


class KLSampler(MLSampler):
    def __init__(self, hierarchy: GeometricHierarchy, covariance: CovarianceFunction,
                 config: ProblemConfig, dtype: torch.dtype = torch.float32, device=None):
        self.hierarchy = hierarchy
        self.covariance = covariance
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.sigma = float(np.sqrt(config.variance))
        self.lognormal = bool(config.lognormal)
        if covariance.num_modes == 0:
            covariance.solve_eigenvalue()
        theta = covariance.eigenvalues
        self.nmodes = theta.shape[0]
        as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                         device=self.device)
        self.sqrt_theta = as_t(np.sqrt(np.maximum(theta, 0.0)))
        # Per-level mode matrices: the eigenvectors, coarsened by the
        # volume-weighted cochain projector.
        evs: List[np.ndarray] = [covariance.eigenvectors]
        for l in range(hierarchy.nlevels - 1):
            Wf = hierarchy.levels[l].W
            Wc = hierarchy.levels[l + 1].W
            coarse = np.zeros((hierarchy.levels[l + 1].n_s, self.nmodes))
            np.add.at(coarse, hierarchy.parent[l], Wf[:, None] * evs[l])
            coarse /= Wc[:, None]
            evs.append(coarse)
        self.modes = [as_t(e.T) for e in evs]  # (modes, n_l)

    def sample_size(self, level: int) -> int:
        return self.nmodes

    def field_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def sample(self, level: int, key: Key, nsamples: int) -> torch.Tensor:
        return self.sigma * sample_normals(key, (nsamples, self.nmodes), self.dtype,
                                           self.device)

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        # xi_level is irrelevant: the modes are shared across levels.
        s = torch.matmul(xi * self.sqrt_theta, self.modes[level])
        return torch.exp(s) if self.lognormal else s

    def nnz(self, level: int) -> int:
        return int(self.modes[level].numel())
