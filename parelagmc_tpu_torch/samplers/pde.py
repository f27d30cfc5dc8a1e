"""SPDE-based Matern random field sampler on tensor meshes.

Port of `SPDESampler` from parelagmc_tpu/samplers/pde.py (see its
docstring for the method). One batch of realizations:

    xi  ~ N(0, sigma^2 I)                      ops/prng.sample_normals (K2)
    rhs = g * sqrt(W) * xi                     white-noise load
    rhs -> restricted through P_l2^T to the target level (MLMC coupling)
    s   = S_level^{-1} rhs                     exact tensor solve
    s  -> exp(s) if log-normal.

The embedded and projection variants and `eval_with_flux` are not ported
yet (ROADMAP Queue 1, items 3 and 11).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.fem.hierarchy import GeometricHierarchy, axis_parent_map
from parelagmc_tpu_torch.utils.special import matern_spde_scaling
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.ops.prng import Key, sample_normals
from parelagmc_tpu_torch.ops.tensorsolve import (
    TensorEig,
    build_tensor_solver,
    tensor_marginal_std,
    tensor_solve,
)
from parelagmc_tpu_torch.samplers.base import MLSampler


def axis_restriction_matrices(fine_mesh, coarse_mesh, dtype, device=None):
    """Per-axis 0/1 aggregation matrices R_a (nc_a, nf_a) whose tensor
    product is P_l2^T for any nested structured coarsening."""
    mats = []
    for a in range(fine_mesh.dim):
        par = axis_parent_map(fine_mesh.axes[a], coarse_mesh.axes[a])
        nf = par.size
        nc = coarse_mesh.axes[a].size - 1
        R = np.zeros((nc, nf))
        R[par, np.arange(nf)] = 1.0
        mats.append(torch.as_tensor(R, dtype=dtype, device=device))
    return tuple(mats)


def restrict_cells_matmul(x: torch.Tensor, mats, fine_shape) -> torch.Tensor:
    """P_l2^T of (..., n_s) fine cell fields via per-axis matmuls."""
    d = len(fine_shape)
    batch = x.shape[:-1]
    z = x.reshape(batch + tuple(fine_shape[::-1]))
    for a in range(d):
        dim = z.ndim - 1 - a
        z = torch.matmul(z.movedim(dim, -1), mats[a].T).movedim(-1, dim)
    return z.reshape(batch + (-1,))


class SPDESampler(MLSampler):
    """SPDE sampler on the original mesh (reference: src/PDESampler.cpp)."""

    def __init__(self, hierarchy: GeometricHierarchy, config: ProblemConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        self.hierarchy = hierarchy
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        d = hierarchy.levels[0].dim
        self.ndim = d
        self.corlen = float(config.correlation_length)
        self.alpha = 1.0 / self.corlen ** 2
        self.g = matern_spde_scaling(self.corlen, d)
        self.sigma = math.sqrt(float(config.variance))
        self.lognormal = bool(config.lognormal)
        self.eigs: List[TensorEig] = [
            build_tensor_solver(lvl.mesh, self.alpha, ess_attr=None, dtype=dtype,
                                device=self.device)
            for lvl in hierarchy.levels
        ]
        # Optional exact marginal normalization (config.normalize_marginals).
        self.field_scale: Optional[List[torch.Tensor]] = None
        if getattr(config, "normalize_marginals", False):
            self.field_scale = [
                torch.as_tensor(1.0 / tensor_marginal_std(eig, self.g), dtype=dtype,
                                device=self.device)
                for eig in self.eigs
            ]
        self.w_sqrt = [
            torch.as_tensor(lvl.w_sqrt, dtype=dtype, device=self.device)
            for lvl in hierarchy.levels
        ]
        self.shapes = [lvl.mesh.shape for lvl in hierarchy.levels]
        self.restrict_mats = [
            axis_restriction_matrices(hierarchy.levels[l].mesh,
                                      hierarchy.levels[l + 1].mesh, dtype,
                                      self.device)
            for l in range(hierarchy.nlevels - 1)
        ]

    def sample_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def field_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def sample(self, level: int, key: Key, nsamples: int) -> torch.Tensor:
        xi = sample_normals(key, (nsamples, self.sample_size(level)), self.dtype,
                            self.device)
        return self.sigma * xi

    def _solve_gaussian(self, level: int, xi: torch.Tensor,
                        xi_level: Optional[int] = None) -> torch.Tensor:
        if xi_level is None:
            xi_level = level
        if xi_level > level:
            raise ValueError("noise must live on the same or a finer level")
        rhs = self.g * self.w_sqrt[xi_level] * xi
        for l in range(xi_level, level):
            rhs = restrict_cells_matmul(rhs, self.restrict_mats[l], self.shapes[l])
        s = tensor_solve(self.eigs[level], rhs)
        if self.field_scale is not None:
            s = s * self.field_scale[level]
        return s

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        return torch.exp(s) if self.lognormal else s
