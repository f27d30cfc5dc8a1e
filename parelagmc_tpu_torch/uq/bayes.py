"""Bayesian inverse problem: parameter-to-observable map and likelihoods.

Port of parelagmc_tpu/uq/bayes.py (reference: ParELAGMC
src/BayesianInverseProblem.cpp). Posterior expectations of a QoI are
computed as ratios of *prior* expectations,

    E_post[Q] = E[Q * Pi(u)] / E[Pi(u)] = E[R] / E[Z],

with the Gaussian likelihood Pi(u) = exp(-|G(u) - y|^2 / (2*noise)) of the
parameter-to-observable map G. Observables:

* m == 0: G = (int_D p) / |D|, the normalized pressure integral;
* m > 0:  G_i = local average pressure over the cells within eps of the
  i-th observation coordinate, G_i = <g_i, p> / sum(g_i).

The functionals are assembled on the finest level on the host and
restricted through the sparse P_l2^T. All maps are batched: compute_G,
likelihood and compute_R take (batch, n_s) coefficient fields on the
solver's device and return per-sample values. G is read off the primal
pressure of `solve_fwd(level, w, return_pressure=True)`: a cold solve (from
the mean-field iterate with config.meanfield_x0), whose Q carries the
adjoint correction when config.adjoint_qoi is on while the pressure does
not. So the pressure, and G with it, is only as accurate as the primal's
stopping rule: at high contrast config.relative_tolerance (which the
adjoint correction makes enough for Q) leaves G percents off.
`pressure_rtol` gives the likelihood's solves a tolerance of their own for
the primal (`solve_fwd(..., rtol=)`; None keeps the configuration's, and
one above it changes nothing). `max_iters` passes a Krylov budget through
to that solve.

Tracing (utils/trace.py): `bayes.likelihood` spans each likelihood call
(level, rows) and `bayes.G` each read-off of G against the functionals
(level, rows); the iterations the tighter tolerance adds count in
`krylov.extra_iterations` (ops/solvers.pcg).

Synthetic reference data y = G(u_ref) + N(0, noise) comes from one prior
draw or from config.bayes_ref_data_file.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.ops.prng import Key, PRNGKey, fold_in, normals_plain
from parelagmc_tpu_torch.parallel.launch import is_main
from parelagmc_tpu_torch.physics.darcy import DarcySolver
from parelagmc_tpu_torch.samplers.base import MLSampler
from parelagmc_tpu_torch.utils import trace


def _rows(w: torch.Tensor) -> int:
    return w.numel() // w.shape[-1]


class BayesianInverseProblem:
    def __init__(self, solver: DarcySolver, prior: MLSampler, config: ProblemConfig,
                 dtype: torch.dtype = torch.float32, pressure_rtol: Optional[float] = None):
        """Runs on the solver's device. `pressure_rtol`: the relative
        tolerance of the primal solve that G reads (None: the
        configuration's)."""
        self.solver = solver
        self.prior = prior
        self.config = config
        self.dtype = dtype
        self.pressure_rtol = pressure_rtol
        self.device = solver.device
        self.noise = float(config.bayes_noise)
        self.m = int(config.bayes_num_obs)
        hierarchy = solver.hierarchy
        self.nlevels = hierarchy.nlevels
        d = hierarchy.levels[0].dim

        # Observation functionals on the pressure space, finest level, then
        # restricted through P_l2^T.
        fine = hierarchy.levels[0]
        n_obs = max(self.m, 1)
        g0 = np.zeros((n_obs, fine.n_s))
        if self.m == 0:
            g0[0] = fine.W
        else:
            coords = np.asarray(config.bayes_obs_coords, dtype=np.float64).reshape(self.m, d)
            centers = fine.mesh.cell_centers()
            for i in range(self.m):
                mask = np.abs(centers - coords[i][None, :]).max(axis=1) <= config.bayes_eps
                if not mask.any():
                    raise ValueError(f"no cells within eps={config.bayes_eps} of obs point {i}")
                g0[i] = np.where(mask, fine.W, 0.0)
        gs: List[np.ndarray] = [g0]
        for l in range(self.nlevels - 1):
            # Sparse restriction g_{l+1} = g_l P (a dense P would be
            # n_fine x n_coarse).
            P_l2 = hierarchy.p_l2(l)
            gs.append(np.asarray((P_l2.T @ gs[l].T).T))
        # Normalized functionals: G_i = <g_i, p> / sum(g_i).
        self.g_obs = [
            torch.as_tensor(g / g.sum(axis=1, keepdims=True), dtype=dtype, device=self.device)
            for g in gs
        ]
        self.G_obs: Optional[torch.Tensor] = None  # (n_obs,)

    @property
    def size_obs_data(self) -> int:
        return max(self.m, 1)

    def _set_obs(self, data: np.ndarray) -> None:
        self.G_obs = torch.as_tensor(np.asarray(data, dtype=np.float64), dtype=self.dtype,
                                     device=self.device)

    # -- observable / likelihood maps (batched) ---------------------------------
    def compute_G(self, level: int, w: torch.Tensor, compute_Q: bool = False,
                  max_iters: Optional[int] = None, return_info: bool = False):
        """G(w) for a batch of coefficient fields, from a solve whose primal
        runs to pressure_rtol. Returns (G, Q, cost), and the solve's
        SolveInfo with return_info. Without a pressure_rtol the call is the
        solver's plain `solve_fwd`, so every solver serves; a pressure_rtol
        needs DarcySolver's `rtol`."""
        tol = {} if self.pressure_rtol is None else {"rtol": self.pressure_rtol}
        Q, cost, info, p = self.solver.solve_fwd(level, w, return_pressure=True,
                                                 max_iters=max_iters, **tol)
        with trace.span("bayes.G", level=level, rows=_rows(w)):
            G = torch.matmul(p, self.g_obs[level].T)  # (batch, n_obs)
        if return_info:
            return G, Q, cost, info
        return G, Q, cost

    def _likelihood_and_Q(self, level: int, w: torch.Tensor, max_iters: Optional[int]):
        """(Pi, Q, cost) of a batch, in the span `bayes.likelihood`: the body
        of both `likelihood` and `likelihood_and_Q`, so that neither calls
        the other (an instrument may wrap either alone)."""
        with trace.span("bayes.likelihood", level=level, rows=_rows(w)):
            G, Q, cost = self.compute_G(level, w, max_iters=max_iters)
            misfit = torch.sum((G - self.G_obs) ** 2, dim=-1)
            return torch.exp(-misfit / (2.0 * self.noise)), Q, cost

    def likelihood(self, level: int, w: torch.Tensor, max_iters: Optional[int] = None):
        """Pi(w) = exp(-|G(w) - y|^2 / (2*noise)). Returns (Pi, cost)."""
        like, _, cost = self._likelihood_and_Q(level, w, max_iters)
        return like, cost

    def likelihood_and_Q(self, level: int, w: torch.Tensor, max_iters: Optional[int] = None):
        return self._likelihood_and_Q(level, w, max_iters)

    def compute_R(self, level: int, w: torch.Tensor, max_iters: Optional[int] = None):
        """R(w) = Q(w) * Pi(w). Returns (R, cost)."""
        like, Q, cost = self.likelihood_and_Q(level, w, max_iters=max_iters)
        return Q * like, cost

    # -- reference observational data --------------------------------------------
    def generate_observational_data(self, key: Optional[Key] = None) -> np.ndarray:
        """y = G(u_ref) + N(0, noise) from one prior draw at the finest
        level, or loaded from config.bayes_ref_data_file when present and
        config.bayes_generate_ref_data is off. The measurement noise eta is
        drawn in float64 on the host whatever config.dtype is: the
        reference draws it with jax.random.normal without a dtype, which
        under its 64-bit setting (its tests and CPU runs) is float64, and
        that is the stream the fixed-seed anchors pin. Under torchrun the
        file is written by rank 0 alone."""
        cfg = self.config
        fname = cfg.bayes_ref_data_file
        if not cfg.bayes_generate_ref_data and fname and os.path.exists(fname):
            data = np.loadtxt(fname).reshape(-1)
            if data.size == self.size_obs_data:
                self._set_obs(data)
                return data
        if key is None:
            key = PRNGKey(cfg.seed + 17)
        xi = self.prior.sample(0, key, 1)
        u = self.prior.eval(0, xi)
        G, _, _ = self.compute_G(0, u)
        eta = np.sqrt(self.noise) * normals_plain(
            fold_in(key, 1), (self.size_obs_data,), torch.float64, "cpu").numpy()
        data = G[0].detach().to("cpu", torch.float64).numpy() + eta
        self._set_obs(data)
        if fname and is_main():
            np.savetxt(fname, data)
        return data

    def set_observational_data(self, y) -> None:
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if y.size != self.size_obs_data:
            raise ValueError(f"expected {self.size_obs_data} observations, got {y.size}")
        self._set_obs(y)
