"""SPDE-based Matern random field samplers (plain, embedded, projection).

Port of parelagmc_tpu/samplers/pde.py (see its docstring for the method).
One batch of realizations:

    xi  ~ N(0, sigma^2 I)                      ops/prng.sample_normals (K2)
    rhs = g * sqrt(W) * xi                     white-noise load
    rhs -> restricted through P_l2^T to the target level (MLMC coupling)
    s   = S_level^{-1} rhs                     exact tensor solve
    s  -> exp(s) if log-normal.

Variants, sharing `_TensorSPDEBase` (per-level tensor solvers on a "solve"
hierarchy):

* SPDESampler             - solve on the original mesh (reflecting boundary
  conditions inflate the variance near the boundary);
* EmbeddedSPDESampler     - solve on a matching enlarged mesh, restrict to
  the original cells by a 0/1 selection (an index_select);
* L2ProjectionSPDESampler - solve on a non-matching enlarged mesh, project
  to the original mesh with the mortar coupling G. On axis-aligned tensor
  grids G is the Kronecker product of 1D interval-overlap matrices, built
  on the host at setup; at run time it is one static ELL apply.

The float32 matmuls (tensor solve, restriction) need full float32
products: on the card the caller keeps TF32 off (PyTorch's default).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.fem.hierarchy import GeometricHierarchy, axis_parent_map
from parelagmc_tpu_torch.mesh.factories import embedded_selection
from parelagmc_tpu_torch.mesh.structured import StructuredMesh
from parelagmc_tpu_torch.ops.ell import ELL, ell_apply, pack_csr_to_ell
from parelagmc_tpu_torch.ops.mass_solve import build_mass_tridiag_solver
from parelagmc_tpu_torch.ops.prng import Key, sample_normals
from parelagmc_tpu_torch.ops.tensorsolve import (
    TensorEig,
    build_tensor_solver,
    tensor_marginal_std,
    tensor_solve,
)
from parelagmc_tpu_torch.samplers.base import MLSampler
from parelagmc_tpu_torch.utils import trace
from parelagmc_tpu_torch.utils.special import matern_spde_scaling


def restrict_cells(x: torch.Tensor, fine_shape: Tuple[int, ...]) -> torch.Tensor:
    """P_l2^T on a dyadic grid: sum a fine cell field (..., prod(fine_shape))
    into the parent cells of the once-coarsened mesh (reshape and sum)."""
    d = len(fine_shape)
    batch = tuple(x.shape[:-1])
    rs: List[int] = []
    for a in range(d - 1, -1, -1):  # array dims are (z, y, x)
        rs.extend([fine_shape[a] // 2, 2])
    z = x.reshape(batch + tuple(rs))
    dims = tuple(len(batch) + 2 * i + 1 for i in range(d))
    return z.sum(dim=dims).reshape(batch + (int(np.prod(fine_shape)) // (2 ** d),))


def prolong_cells(x: torch.Tensor, coarse_shape: Tuple[int, ...]) -> torch.Tensor:
    """P_l2 on a dyadic grid: inject a coarse cell field into the children
    of the refined mesh (piecewise-constant prolongation)."""
    d = len(coarse_shape)
    batch = tuple(x.shape[:-1])
    z = x.reshape(batch + tuple(coarse_shape[::-1]))
    for i in range(d):
        z = torch.repeat_interleave(z, 2, dim=len(batch) + i)
    return z.reshape(batch + (int(np.prod(coarse_shape)) * (2 ** d),))


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


class _TensorSPDEBase(MLSampler):
    """Shared machinery: per-level tensor solvers on a 'solve' hierarchy."""

    def __init__(self, solve_hierarchy: GeometricHierarchy, config: ProblemConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        self.hierarchy = solve_hierarchy
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        d = solve_hierarchy.levels[0].dim
        self.ndim = d
        self.corlen = float(config.correlation_length)
        self.alpha = 1.0 / self.corlen ** 2
        self.g = matern_spde_scaling(self.corlen, d)
        self.sigma = math.sqrt(float(config.variance))
        self.lognormal = bool(config.lognormal)
        self.eigs: List[TensorEig] = [
            build_tensor_solver(lvl.mesh, self.alpha, ess_attr=None, dtype=dtype,
                                device=self.device)
            for lvl in solve_hierarchy.levels
        ]
        # Optional exact marginal normalization (config.normalize_marginals).
        self.field_scale: Optional[List[torch.Tensor]] = None
        if config.normalize_marginals:
            self.field_scale = [
                torch.as_tensor(1.0 / tensor_marginal_std(eig, self.g), dtype=dtype,
                                device=self.device)
                for eig in self.eigs
            ]
        self.w_sqrt = [
            torch.as_tensor(lvl.w_sqrt, dtype=dtype, device=self.device)
            for lvl in solve_hierarchy.levels
        ]
        self.shapes = [lvl.mesh.shape for lvl in solve_hierarchy.levels]
        self.restrict_mats = [
            axis_restriction_matrices(solve_hierarchy.levels[l].mesh,
                                      solve_hierarchy.levels[l + 1].mesh, dtype,
                                      self.device)
            for l in range(solve_hierarchy.nlevels - 1)
        ]

    def sample_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def sample(self, level: int, key: Key, nsamples: int) -> torch.Tensor:
        with trace.span("sampler.sample", level=level, rows=nsamples):
            xi = sample_normals(key, (nsamples, self.sample_size(level)), self.dtype,
                                self.device)
            return self.sigma * xi

    def _solve_gaussian(self, level: int, xi: torch.Tensor,
                        xi_level: Optional[int] = None) -> torch.Tensor:
        """The Gaussian field on the solve mesh of `level`."""
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

    def _finish(self, s: torch.Tensor) -> torch.Tensor:
        return torch.exp(s) if self.lognormal else s

    def nnz(self, level: int) -> int:
        # Modal operator size: eigen-factor entries.
        return sum(int(v.shape[0]) ** 2 for v in self.eigs[level].V) + int(
            np.prod(self.shapes[level]))


class SPDESampler(_TensorSPDEBase):
    """SPDE sampler on the original mesh (reference: src/PDESampler.cpp)."""

    def __init__(self, hierarchy: GeometricHierarchy, config: ProblemConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(hierarchy, config, dtype, device)
        self._flux = {}  # per level: (mass solver, face tables) of eval_with_flux

    def field_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        with trace.span("sampler.eval", level=level, rows=xi.numel() // max(1, xi.shape[-1])):
            return self._finish(self._solve_gaussian(level, xi, xi_level))

    def eval_with_flux(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        """(s, u): the field and the auxiliary H(div) flux of the mixed SPDE
        system, u = -M^{-1} B^T s_gauss with u.n = 0 on the boundary (the
        reference's Eval overload returning the velocity block,
        src/PDESampler.cpp:537-613). Both get exp() under the log-normal
        flag, as there."""
        s_g = self._solve_gaussian(level, xi, xi_level)
        lvl = self.hierarchy.levels[level]
        if level not in self._flux:
            ess = lvl.ess_faces(np.ones(2 * self.ndim, dtype=int))
            dev = self.device
            self._flux[level] = (
                build_mass_tridiag_solver(lvl, ess, dtype=self.dtype, device=dev),
                torch.as_tensor(ess, device=dev),
                torch.as_tensor(lvl.face_cells, dtype=torch.int64, device=dev),
                torch.as_tensor(lvl.face_signs, dtype=self.dtype, device=dev),
            )
        solver, ess, face_cells, face_signs = self._flux[level]
        gathered = torch.index_select(s_g, -1, face_cells.reshape(-1)).reshape(
            s_g.shape[:-1] + face_cells.shape)
        bts = torch.sum(gathered * face_signs, dim=-1)
        bts = torch.where(ess, torch.zeros_like(bts), bts)
        ones = torch.ones(s_g.shape[:-1] + (lvl.n_s,), dtype=self.dtype, device=self.device)
        u = -solver(ones, bts)
        return self._finish(s_g), self._finish(u)


class EmbeddedSPDESampler(_TensorSPDEBase):
    """SPDE sampler on a matching enlarged mesh with 0/1 selection back to
    the original mesh (reference: src/EmbeddedPDESampler.cpp). Avoids the
    boundary variance inflation of the plain sampler."""

    def __init__(self, hierarchy: GeometricHierarchy, embed_hierarchy: GeometricHierarchy,
                 config: ProblemConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(embed_hierarchy, config, dtype, device)
        self.orig_hierarchy = hierarchy
        # Per-level selection: the embedded cells that are the original
        # cells (both base meshes refine in lockstep, so the embedding
        # matches on every level). int64: PyTorch's index dtype.
        self.selection = [
            torch.as_tensor(
                embedded_selection(embed_hierarchy.levels[l].mesh, hierarchy.levels[l].mesh),
                dtype=torch.int64, device=self.device)
            for l in range(hierarchy.nlevels)
        ]

    def field_size(self, level: int) -> int:
        return self.orig_hierarchy.levels[level].n_s

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        return self._finish(torch.index_select(s, -1, self.selection[level]))

    def embed_eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        """Realization on the full embedded mesh."""
        return self._finish(self._solve_gaussian(level, xi, xi_level))


def overlap_matrix_1d(orig_axis: np.ndarray, embed_axis: np.ndarray) -> sp.csr_matrix:
    """1D interval-overlap matrix O[i, j] = |cell_i(orig) intersect cell_j(embed)|."""
    no, ne = orig_axis.size - 1, embed_axis.size - 1
    rows, cols, vals = [], [], []
    for i in range(no):
        a0, a1 = orig_axis[i], orig_axis[i + 1]
        j0 = max(np.searchsorted(embed_axis, a0, side="right") - 1, 0)
        for j in range(j0, ne):
            b0, b1 = embed_axis[j], embed_axis[j + 1]
            if b0 >= a1 - 1e-14:
                break
            ov = min(a1, b1) - max(a0, b0)
            if ov > 1e-14:
                rows.append(i)
                cols.append(j)
                vals.append(ov)
    return sp.csr_matrix((vals, (rows, cols)), shape=(no, ne))


def mortar_coupling(orig: StructuredMesh, embed: StructuredMesh) -> sp.csr_matrix:
    """Tensor-grid mortar coupling G[i, j] = |K_i^orig intersect K_j^embed|
    (the L2 mortar mass between the two P0 spaces): the Kronecker product of
    the 1D overlaps, axes ordered so x varies fastest."""
    G = None
    for a in range(orig.dim - 1, -1, -1):
        Oa = overlap_matrix_1d(orig.axes[a], embed.axes[a])
        G = Oa if G is None else sp.kron(G, Oa, format="csr")
    return G.tocsr()


class L2ProjectionSPDESampler(_TensorSPDEBase):
    """SPDE sampler on a non-matching enlarged mesh with mortar L2
    projection back to the original mesh (reference:
    src/L2ProjectionPDESampler.cpp): s_orig = W_orig^{-1} G s_embed, with G
    rediscretized on each level pair (equal to the Galerkin triple product
    of the P0 injections)."""

    def __init__(self, hierarchy: GeometricHierarchy, embed_hierarchy: GeometricHierarchy,
                 config: ProblemConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(embed_hierarchy, config, dtype, device)
        self.orig_hierarchy = hierarchy
        self.G: List[ELL] = []
        self.Gt: List[ELL] = []
        self.winv_orig = []
        self.winv_embed = []
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=self.device)
        for l in range(hierarchy.nlevels):
            G = mortar_coupling(hierarchy.levels[l].mesh, embed_hierarchy.levels[l].mesh)
            if G[0].sum() <= 0:
                raise ValueError("No intersection, no transfer!")
            self.G.append(pack_csr_to_ell(G, dtype, device=self.device))
            self.Gt.append(pack_csr_to_ell(G.T.tocsr(), dtype, device=self.device))
            self.winv_orig.append(as_t(1.0 / hierarchy.levels[l].W))
            self.winv_embed.append(as_t(1.0 / embed_hierarchy.levels[l].W))

    def field_size(self, level: int) -> int:
        return self.orig_hierarchy.levels[level].n_s

    def project(self, level: int, s_embed: torch.Tensor) -> torch.Tensor:
        return self.winv_orig[level] * ell_apply(self.G[level], s_embed)

    def transfer(self, level: int, x_embed: torch.Tensor) -> torch.Tensor:
        """L2-project an embedded cell field to the original mesh."""
        return self.project(level, x_embed)

    def transfer_to_embed(self, level: int, x_orig: torch.Tensor) -> torch.Tensor:
        """L2-project an original-mesh cell field to the embedded mesh."""
        return self.winv_embed[level] * ell_apply(self.Gt[level], x_orig)

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        return self._finish(self.project(level, s))

    def embed_eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        return self._finish(self._solve_gaussian(level, xi, xi_level))
