"""Mixed Darcy forward model with per-sample permeability, cg-schur family.

Port of parelagmc_tpu/physics/darcy.py for the solver the golden MLMC path
runs ("cg-schur", see the reference's docstring for the formulation). Per
realization of the coefficient w, solve

    [[M(w), B^T], [B, 0]] [u; p~] = [f; g]      (p~ = -p convention)

by CG on the pressure Schur complement S(w) = B M(w)^{-1} B^T, with
M(w)^{-1} applied exactly by batched tridiagonal line solves
(ops/mass_solve.py, kernel K1) and S(1)^{-1} by the tensor spectral solver
as preconditioner, scaled either by the per-sample geometric mean of w or,
with `local_schur_scaling`, symmetrically by sqrt(w) per cell.

QoI functionals (eff_perm, p_int, local_avg_p) are assembled on the finest
level and restricted through P^T exactly like the reference.

Not ported yet - each raises NotImplementedError naming its ROADMAP item:
kinv_ref (static permeability) and the solvers minres-bj,
cg-schur-coefmg/-diag/-exact, and the options adjoint_qoi, meanfield_x0 and
spatial_shards.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import GeometricHierarchy
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.ops.mass_solve import MassTridiagSolver, build_mass_tridiag_solver
from parelagmc_tpu_torch.ops.solvers import pcg
from parelagmc_tpu_torch.ops.tensorsolve import TensorEig, build_tensor_solver, tensor_solve

_ROADMAP = "not ported yet (ROADMAP.md Queue 1, item {item})"


class DarcyLevel(nn.Module):
    """Device operators of one level for the cg-schur solver."""

    def __init__(self, n_u: int, n_s: int, rhs: torch.Tensor, obs_func: torch.Tensor, schur: TensorEig,
                 mass_solver: MassTridiagSolver, shape, face_offsets, b_masks):
        super().__init__()
        self.n_u = int(n_u)
        self.n_s = int(n_s)
        self.register_buffer("rhs", rhs)  # (n_u + n_s,), essential data zeroed
        self.register_buffer("obs_func", obs_func)  # (n_u + n_s,)
        self.schur = schur  # exact S(1) factors (alpha = 0, Darcy BCs)
        self.mass_solver = mass_solver  # exact M(w)^{-1}
        # Slicing-form B / B^T: per-axis float masks (0 at essential faces)
        # in face-grid layout (z, y, x).
        self.shape = tuple(int(s) for s in shape)
        self.face_offsets = tuple(int(x) for x in face_offsets)
        for a, m in enumerate(b_masks):
            self.register_buffer(f"b_mask{a}", m)

    @property
    def b_masks(self):
        return tuple(getattr(self, f"b_mask{a}") for a in range(len(self.shape)))


def _outward_sign(lvl) -> np.ndarray:
    """Outward-normal sign of every boundary face's +axis dof."""
    mesh = lvl.mesh
    out = np.zeros(lvl.n_u)
    for a in range(mesh.dim):
        shape = mesh.face_grid_shape(a)
        grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        i_a = grids[a].ravel(order="F")
        fidx = mesh.face_offsets[a] + np.arange(int(np.prod(shape)))
        out[fidx[i_a == 0]] = -1.0
        out[fidx[i_a == shape[a] - 1]] = +1.0
    return out


def _b_masks(mesh, ess: np.ndarray) -> List[np.ndarray]:
    """Per-axis essential-mask face grids for the slicing-form B/B^T."""
    masks = []
    for a in range(mesh.dim):
        fshape = list(mesh.shape)
        fshape[a] += 1
        m = (~ess[mesh.face_offsets[a]: mesh.face_offsets[a + 1]]).astype(np.float64)
        masks.append(m.reshape(tuple(fshape[::-1])))
    return masks


def _check_config(config: ProblemConfig) -> None:
    cfg = config.darcy_solver
    if cfg.name != "cg-schur":
        item = 10 if cfg.name == "cg-schur-coefmg" else 13
        raise NotImplementedError(f"darcy solver {cfg.name!r} " + _ROADMAP.format(item=item))
    for flag, item in (("adjoint_qoi", 6), ("adjoint_stacked", 6), ("meanfield_x0", 6)):
        if getattr(cfg, flag, False):
            raise NotImplementedError(f"{flag} " + _ROADMAP.format(item=item))
    if int(getattr(cfg, "spatial_shards", 0) or 0) > 1:
        raise NotImplementedError("spatial_shards " + _ROADMAP.format(item=14))


class DarcySolver:
    def __init__(
        self,
        hierarchy: GeometricHierarchy,
        config: ProblemConfig,
        dtype: torch.dtype = torch.float32,
        device=None,
        kinv_ref: Optional[np.ndarray] = None,
    ):
        if kinv_ref is not None:
            raise NotImplementedError("kinv_ref " + _ROADMAP.format(item="6/7"))
        _check_config(config)
        self.hierarchy = hierarchy
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.solver_cfg = config.darcy_solver
        d = hierarchy.levels[0].dim
        nb = 2 * d
        ess_attr = np.asarray(config.ess_attr[:nb], dtype=np.int64)
        obs_attr = np.asarray(config.obs_attr[:nb], dtype=np.int64)
        inflow_attr = np.asarray(config.inflow_attr[:nb], dtype=np.int64)

        # --- finest-level functionals, then restrict through P^T -----------
        fine = hierarchy.levels[0]
        n_u0, n_s0 = fine.n_u, fine.n_s
        bdr = fine.bdr_attr  # (n_u,) 0 = interior
        outward = _outward_sign(fine)
        rhs_u0 = np.zeros(n_u0)
        on_inflow = (bdr > 0) & (inflow_attr[np.maximum(bdr - 1, 0)] == 1)
        # p_bar = +1 on the inflow boundary (reference inflow coefficient -1).
        rhs_u0[on_inflow] = -1.0 * outward[on_inflow]
        rhs0 = np.concatenate([rhs_u0, np.zeros(n_s0)])
        obs0 = np.zeros(n_u0 + n_s0)
        if config.qoi == "eff_perm":
            on_obs = (bdr > 0) & (obs_attr[np.maximum(bdr - 1, 0)] == 1)
            obs0[:n_u0][on_obs] = outward[on_obs]
        elif config.qoi == "p_int":
            obs0[n_u0:] = -fine.W  # integral of the physical pressure p = -p~
        elif config.qoi == "local_avg_p":
            mask = (
                np.abs(fine.mesh.cell_centers()
                       - np.asarray(config.qoi_point)[None, :d]).max(axis=1)
                <= config.qoi_eps
            )
            obs0[n_u0:] = np.where(mask, -fine.W, 0.0)
        else:
            raise ValueError(f"unknown QoI '{config.qoi}'")
        rhs_np = [rhs0]
        obs_np = [obs0]
        for l in range(hierarchy.nlevels - 1):
            P_rt = hierarchy.P_rt[l]
            P_l2 = hierarchy.p_l2(l)
            n_u = hierarchy.levels[l].n_u
            for vecs in (rhs_np, obs_np):
                vecs.append(np.concatenate([P_rt.T @ vecs[l][:n_u],
                                            P_l2.T @ vecs[l][n_u:]]))

        dev = self.device
        as_t = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                                   device=dev)
        levels = []
        for l, lvl in enumerate(hierarchy.levels):
            ess = lvl.ess_faces(ess_attr)
            rhs_l = rhs_np[l].copy()
            rhs_l[: lvl.n_u][ess] = 0.0  # zero essential data (reference default)
            levels.append(
                DarcyLevel(
                    n_u=lvl.n_u,
                    n_s=lvl.n_s,
                    rhs=as_t(rhs_l),
                    obs_func=as_t(obs_np[l]),
                    schur=build_tensor_solver(lvl.mesh, 0.0, ess_attr=ess_attr,
                                              dtype=dtype, device=dev),
                    mass_solver=build_mass_tridiag_solver(lvl, ess, dtype=dtype,
                                                          device=dev),
                    shape=lvl.mesh.shape,
                    face_offsets=lvl.mesh.face_offsets,
                    b_masks=[as_t(m) for m in _b_masks(lvl.mesh, ess)],
                )
            )
        self.levels = nn.ModuleList(levels)
        # Parent cell maps for the warm-started pair solves (coarse -> fine
        # piecewise-constant pressure prolongation).
        self._parent = [as_t(p, torch.int64) for p in hierarchy.parent]

    # -- public API ------------------------------------------------------------
    def num_dofs(self, level: int) -> int:
        L = self.levels[level]
        return L.n_u + L.n_s

    @staticmethod
    def _apply_B(L: DarcyLevel, u: torch.Tensor) -> torch.Tensor:
        """Divergence B u by the slicing stencil: on each axis the masked
        face grid t gives (B u)_i = t_{i+1} - t_i."""
        shape, offs = L.shape, L.face_offsets
        batch = u.shape[:-1]
        y = None
        for a, mask in enumerate(L.b_masks):
            fshape = list(shape)
            fshape[a] += 1
            t = u[..., offs[a]: offs[a + 1]].reshape(batch + tuple(fshape[::-1])) * mask
            ax = t.ndim - 1 - a
            contrib = t.narrow(ax, 1, shape[a]) - t.narrow(ax, 0, shape[a])
            y = contrib if y is None else y + contrib
        return y.reshape(batch + (-1,))

    @staticmethod
    def _apply_Bt(L: DarcyLevel, p: torch.Tensor) -> torch.Tensor:
        """Gradient-form B^T p: (B^T p)_f = p_lo - p_hi, zero outside the
        domain, essential rows masked."""
        shape = L.shape
        batch = p.shape[:-1]
        pg = p.reshape(batch + tuple(shape[::-1]))
        outs = []
        for a, mask in enumerate(L.b_masks):
            ax = pg.ndim - 1 - a
            pp = F.pad(pg, (0, 0) * a + (1, 1))  # pad array dim ax by one each side
            t = mask * (pp.narrow(ax, 0, shape[a] + 1) - pp.narrow(ax, 1, shape[a] + 1))
            outs.append(t.reshape(batch + (-1,)))
        return torch.cat(outs, dim=-1)

    def solve_fwd(self, level: int, w: torch.Tensor, return_pressure: bool = False):
        """Solve for a batch of coefficient fields w (..., n_s). Returns
        (Q, cost, info[, p]) with p the physical pressure."""
        return self._solve_cg_schur(self.levels[level], w, return_pressure)

    def solve_fwd_warm(self, level: int, w: torch.Tensor, p_coarse: torch.Tensor,
                       return_pressure: bool = False):
        """Fine solve warm-started from the level+1 physical pressure: every
        fine cell takes its parent's value (P0 prolongation)."""
        p0 = torch.index_select(p_coarse, -1, self._parent[level])
        return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=p0)

    def solve_fwd_pair(self, level: int, w_f: torch.Tensor, w_c: torch.Tensor):
        """Coupled (fine, coarse) pair for one MLMC correction: solve
        level+1, then warm-start the level solve from its pressure.
        Returns (q_fine, q_coarse, info_fine, info_coarse)."""
        qc, _, info_c, p_c = self.solve_fwd(level + 1, w_c, return_pressure=True)
        q, _, info_f = self.solve_fwd_warm(level, w_f, p_c)
        return q, qc, info_f, info_c

    def _solve_cg_schur(self, L: DarcyLevel, w: torch.Tensor, return_pressure: bool,
                        x0: Optional[torch.Tensor] = None):
        batch = w.shape[:-1]
        f = L.rhs[: L.n_u].expand(batch + (L.n_u,))
        g = L.rhs[L.n_u:].expand(batch + (L.n_s,))
        # Factor the tridiagonal mass tables once per solve.
        mass_fac = L.mass_solver.factor(w)
        Minv = lambda r: L.mass_solver.apply_factored(mass_fac, r)
        rhs_s = self._apply_B(L, Minv(f)) - g
        if self.solver_cfg.local_schur_scaling:
            # S(w)^{-1} ~ diag(w)^{1/2} S(1)^{-1} diag(w)^{1/2}.
            sw = torch.sqrt(w)
            prec = lambda r: sw * tensor_solve(L.schur, sw * r)
        else:
            # S(w)^{-1} ~ w_bar S(1)^{-1}, w_bar the per-sample geometric mean.
            w_bar = torch.exp(torch.mean(torch.log(w), dim=-1, keepdim=True))
            prec = lambda r: w_bar * tensor_solve(L.schur, r)
        apply_S = lambda p: self._apply_B(L, Minv(self._apply_Bt(L, p)))
        cfg = self.solver_cfg
        p, info = pcg(
            apply_S,
            rhs_s,
            prec=prec,
            x0=(-x0 if x0 is not None else None),  # p~ = -p convention
            max_iters=cfg.max_iterations,
            rtol=cfg.relative_tolerance,
            atol=cfg.absolute_tolerance,
            restart_every=cfg.restart_every,
        )
        u = Minv(f - self._apply_Bt(L, p))
        Q = torch.sum(p * L.obs_func[L.n_u:], dim=-1) + torch.sum(
            u * L.obs_func[: L.n_u], dim=-1
        )
        cost = float(L.n_u + L.n_s)
        if return_pressure:
            return Q, cost, info, -p
        return Q, cost, info
