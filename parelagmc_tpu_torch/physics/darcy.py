"""Mixed Darcy forward model with per-sample permeability, cg-schur family.

Port of parelagmc_tpu/physics/darcy.py for its batched Schur-CG solvers
(see the reference's docstring for the formulation). Per realization of
the coefficient w, solve

    [[M(w), B^T], [B, 0]] [u; p~] = [f; g]      (p~ = -p convention)

by CG on the pressure Schur complement S(w) = B M(w)^{-1} B^T, with
M(w)^{-1} applied exactly by batched tridiagonal line solves
(ops/mass_solve.py, kernel K1). Preconditioners, by config name:

* "cg-schur" (without a kinv_ref): the exact reference-coefficient inverse
  S(1)^{-1} (tensor spectral solver), scaled by the per-sample geometric
  mean of w or, with `local_schur_scaling`, symmetrically by sqrt(w) per
  cell;
* "cg-schur-coefmg": the per-sample Galerkin Schur multigrid
  (ops/coef_multigrid_structured.py), rebuilt from this sample's masked
  mass diagonal, optionally with a bfloat16 state (`coefmg_prec_dtype`)
  and line smoothing on K1.

A static inverse permeability `kinv_ref` on the finest mesh enters every
level's M(w): by default through the energy-consistent Galerkin blocks of
fem/galerkin_mass.py (rhs and QoI restricted through the matching adapted
RT embedding), or rediscretized by volume averaging
(config.coarse_operators="rediscretize").

QoI functionals (eff_perm, p_int, local_avg_p) are assembled on the finest
level and restricted through P^T exactly like the reference; `adjoint_qoi`
adds the goal-oriented correction lam^T r from a second (adjoint) Schur
solve, and `meanfield_x0` starts every cold solve from a cached w = 1
solution.

Still raising NotImplementedError, each naming its ROADMAP item: the
solvers minres-bj, cg-schur-diag and cg-schur-exact, "cg-schur" with a
kinv_ref (its static Schur MG), the gather coefMG (coefmg_impl="gather"), adjoint_stacked and
spatial_shards.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.fem.galerkin_mass import (
    effective_kinv,
    galerkin_block_chain,
    weighted_rt_prolongator,
)
from parelagmc_tpu_torch.fem.hierarchy import GeometricHierarchy
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.ops.coef_multigrid_structured import (
    StructCoefMG,
    build_struct_coef_mg,
    cast_state,
    parse_line_axes,
    struct_mg_setup,
    struct_s_apply,
    struct_v_cycle,
)
from parelagmc_tpu_torch.ops.mass_solve import MassTridiagSolver, build_mass_tridiag_solver
from parelagmc_tpu_torch.ops.solvers import SolveInfo, pcg
from parelagmc_tpu_torch.ops.tensorsolve import TensorEig, build_tensor_solver, tensor_solve

_ROADMAP = "not ported yet (ROADMAP.md Queue 1, item {item})"
_SOLVERS = ("cg-schur", "cg-schur-coefmg")
_PREC_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64}
# The meanfield setup solve may continue through up to this many bounded
# executions of max_iterations each in the reference
# (parelagmc_tpu/physics/darcy.py:797); here
# it is one solve with that total budget.
_MEANFIELD_SEGMENTS = 16


class DarcyLevel(nn.Module):
    """Device operators of one level for the cg-schur solver."""

    def __init__(self, n_u: int, n_s: int, rhs: torch.Tensor, obs_func: torch.Tensor, schur: TensorEig,
                 mass_solver: MassTridiagSolver, shape, face_offsets, b_masks,
                 coef_mg: Optional[StructCoefMG] = None):
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
        self.coef_mg = coef_mg  # per-sample Galerkin Schur MG (cg-schur-coefmg)

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


def _check_config(config: ProblemConfig, has_kinv: bool) -> None:
    cfg = config.darcy_solver
    if cfg.name not in _SOLVERS:
        raise NotImplementedError(f"darcy solver {cfg.name!r} " + _ROADMAP.format(item=13))
    if cfg.name == "cg-schur" and has_kinv:
        raise NotImplementedError(
            "cg-schur with a kinv_ref (the static Schur MG of ops/multigrid.py) "
            + _ROADMAP.format(item=13))
    if cfg.name == "cg-schur-coefmg" and getattr(cfg, "coefmg_impl", "auto") == "gather":
        raise NotImplementedError("coefmg_impl='gather' " + _ROADMAP.format(item=13))
    if getattr(cfg, "adjoint_qoi", False) and getattr(cfg, "adjoint_stacked", False):
        raise NotImplementedError("adjoint_stacked " + _ROADMAP.format(item=10))
    if int(getattr(cfg, "spatial_shards", 0) or 0) > 1:
        raise NotImplementedError("spatial_shards " + _ROADMAP.format(item=14))
    pdt = getattr(cfg, "coefmg_prec_dtype", "")
    if pdt and pdt not in _PREC_DTYPES:
        raise ValueError(f"coefmg_prec_dtype {pdt!r}: expected one of {sorted(_PREC_DTYPES)}")


def _kinv_levels(hierarchy: GeometricHierarchy, config: ProblemConfig,
                 kinv_ref: Optional[np.ndarray]):
    """(kinv_levels, blocks_chain, p_weights) of the reference's setup
    (parelagmc_tpu/physics/darcy.py:326-357): the Galerkin block chain with its effective kinv
    per level and the adapted embeddings' line weights, or the
    volume-averaged (rediscretized) kinv per level."""
    n = hierarchy.nlevels
    d = hierarchy.levels[0].dim
    kinv_levels: List[Optional[np.ndarray]] = [None] * n
    if kinv_ref is None:
        return kinv_levels, None, [None] * (n - 1)
    kinv_ref = np.asarray(kinv_ref, dtype=np.float64)
    if kinv_ref.ndim == 1:
        kinv_ref = np.repeat(kinv_ref[:, None], d, axis=1)
    if getattr(config, "coarse_operators", "galerkin") == "galerkin":
        chain, p_weights = galerkin_block_chain([lvl.mesh for lvl in hierarchy.levels], kinv_ref)
        kinv_levels = [effective_kinv(hierarchy.levels[l].mesh, chain[l]) for l in range(n)]
        return kinv_levels, chain, p_weights
    kinv_levels[0] = kinv_ref
    for l in range(n - 1):
        coarse = np.zeros((hierarchy.levels[l + 1].n_s, d))
        np.add.at(coarse, hierarchy.parent[l], hierarchy.levels[l].W[:, None] * kinv_levels[l])
        kinv_levels[l + 1] = coarse / hierarchy.levels[l + 1].W[:, None]
    return kinv_levels, None, [None] * (n - 1)


class DarcySolver:
    def __init__(
        self,
        hierarchy: GeometricHierarchy,
        config: ProblemConfig,
        dtype: torch.dtype = torch.float32,
        device=None,
        kinv_ref: Optional[np.ndarray] = None,
    ):
        """kinv_ref: optional static inverse permeability on the FINEST mesh,
        (n_s, dim) per axis or (n_s,); the per-sample w multiplies on top."""
        _check_config(config, kinv_ref is not None)
        self.hierarchy = hierarchy
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.solver_cfg = config.darcy_solver
        self._mf_cache = {}  # per-level mean-field iterates (meanfield_x0)
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

        kinv_levels, blocks_chain, p_weights = _kinv_levels(hierarchy, config, kinv_ref)
        # Restrict rhs/obs through the exact block prolongator transpose (the
        # energy-adapted embedding with Galerkin blocks).
        rhs_np = [rhs0]
        obs_np = [obs0]
        for l in range(hierarchy.nlevels - 1):
            if p_weights[l] is not None:
                P_rt = weighted_rt_prolongator(hierarchy.levels[l].mesh,
                                               hierarchy.levels[l + 1].mesh, p_weights[l])
            else:
                P_rt = hierarchy.P_rt[l]
            P_l2 = hierarchy.p_l2(l)
            n_u = hierarchy.levels[l].n_u
            for vecs in (rhs_np, obs_np):
                vecs.append(np.concatenate([P_rt.T @ vecs[l][:n_u],
                                            P_l2.T @ vecs[l][n_u:]]))

        dev = self.device
        as_t = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                                   device=dev)
        cfg = self.solver_cfg
        levels = []
        for l, lvl in enumerate(hierarchy.levels):
            ess = lvl.ess_faces(ess_attr)
            rhs_l = rhs_np[l].copy()
            rhs_l[: lvl.n_u][ess] = 0.0  # zero essential data (reference default)
            kinv = kinv_levels[l]
            coef_mg = None
            if cfg.name == "cg-schur-coefmg":
                coef_mg = build_struct_coef_mg(
                    lvl.mesh,
                    cutoff=cfg.coarse_dense_cutoff,
                    coarse_sweeps=max(1, cfg.mg_coarse_sweeps),
                    omega=getattr(cfg, "coefmg_omega", 0.8),
                    cheby_order=getattr(cfg, "coefmg_cheby_order", 0),
                    cheby_lo=getattr(cfg, "coefmg_cheby_lo", 0.25),
                    line_axes=parse_line_axes(getattr(cfg, "coefmg_line_axes", ""),
                                              lvl.mesh, kinv),
                    line_omega=getattr(cfg, "coefmg_line_omega", 1.0),
                    coarsen=getattr(cfg, "coefmg_coarsen", "galerkin"),
                )
            levels.append(
                DarcyLevel(
                    n_u=lvl.n_u,
                    n_s=lvl.n_s,
                    rhs=as_t(rhs_l),
                    obs_func=as_t(obs_np[l]),
                    schur=build_tensor_solver(lvl.mesh, 0.0, ess_attr=ess_attr,
                                              dtype=dtype, device=dev),
                    mass_solver=build_mass_tridiag_solver(
                        lvl, ess, kinv_ref=kinv, dtype=dtype, device=dev,
                        axis_blocks=blocks_chain[l] if blocks_chain is not None else None),
                    shape=lvl.mesh.shape,
                    face_offsets=lvl.mesh.face_offsets,
                    b_masks=[as_t(m) for m in _b_masks(lvl.mesh, ess)],
                    coef_mg=coef_mg,
                )
            )
        self.levels = nn.ModuleList(levels)
        self.kinv_levels = kinv_levels  # host copies, per level (None without kinv_ref)
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

    def adjoint_pair_enabled(self, level: int) -> bool:
        """Does the MLMC pair at this level run the adjoint-corrected QoI,
        with the coarse adjoint warm-starting the fine one?"""
        return bool(getattr(self.solver_cfg, "adjoint_qoi", False))

    def solve_fwd(self, level: int, w: torch.Tensor, return_pressure: bool = False,
                  return_adjoint: bool = False, max_iters: Optional[int] = None):
        """Solve for a batch of coefficient fields w (..., n_s). Returns
        (Q, cost, info[, p[, lam]]) with p the physical pressure and lam the
        adjoint (return_adjoint, needs config.adjoint_qoi). With
        config.meanfield_x0 the solve starts from the cached w = 1 solution.
        `max_iters` overrides config.max_iterations for this solve."""
        x0 = lam0 = None
        if getattr(self.solver_cfg, "meanfield_x0", False):
            p_ref, lam_ref = self._meanfield_start(level)
            batch = w.shape[:-1]
            x0 = p_ref.expand(batch + p_ref.shape[-1:])
            if lam_ref is not None:
                lam0 = lam_ref.expand(batch + lam_ref.shape[-1:])
        return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=x0, lam0=lam0,
                                    return_adjoint=return_adjoint, max_iters=max_iters)

    def _meanfield_start(self, level: int):
        """(p, lam) of ONE solve with w == 1 at this level (lam None without
        adjoint_qoi), computed at first use and cached: the mean-field
        initial iterate of config.meanfield_x0."""
        if level not in self._mf_cache:
            L = self.levels[level]
            adjoint = bool(getattr(self.solver_cfg, "adjoint_qoi", False))
            ones = torch.ones((1, L.n_s), dtype=self.dtype, device=self.device)
            out = self._solve_cg_schur(
                L, ones, True, return_adjoint=adjoint,
                max_iters=_MEANFIELD_SEGMENTS * self.solver_cfg.max_iterations)
            self._mf_cache[level] = (out[3][0], out[4][0] if adjoint else None)
        return self._mf_cache[level]

    def solve_fwd_warm(self, level: int, w: torch.Tensor, p_coarse: torch.Tensor,
                       return_pressure: bool = False, lam_c: Optional[torch.Tensor] = None,
                       return_adjoint: bool = False, max_iters: Optional[int] = None):
        """Fine solve warm-started from the level+1 physical pressure (and,
        with lam_c, the level+1 adjoint): every fine cell takes its
        parent's value (P0 prolongation)."""
        p0 = torch.index_select(p_coarse, -1, self._parent[level])
        lam0 = torch.index_select(lam_c, -1, self._parent[level]) if lam_c is not None else None
        return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=p0, lam0=lam0,
                                    return_adjoint=return_adjoint, max_iters=max_iters)

    def solve_fwd_x0(self, level: int, w: torch.Tensor, p0: torch.Tensor,
                     return_pressure: bool = False, lam0: Optional[torch.Tensor] = None,
                     return_adjoint: bool = False, max_iters: Optional[int] = None):
        """Continue or restart the level solve from a SAME-level physical
        pressure iterate p0 (and adjoint iterate lam0). Kept for parity with
        the reference's API, whose examples continue solves with it; no
        path of this package calls it (MLMCManager runs each pair solve
        composed instead)."""
        return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=p0, lam0=lam0,
                                    return_adjoint=return_adjoint, max_iters=max_iters)

    def solve_fwd_pair(self, level: int, w_f: torch.Tensor, w_c: torch.Tensor,
                       max_iters: Optional[int] = None):
        """Coupled (fine, coarse) pair for one MLMC correction: solve
        level+1, then warm-start the level solve from its pressure (and its
        adjoint, with adjoint_qoi). Returns (q_fine, q_coarse, info_fine,
        info_coarse)."""
        if self.adjoint_pair_enabled(level):
            qc, _, info_c, p_c, lam_c = self.solve_fwd(
                level + 1, w_c, return_pressure=True, return_adjoint=True, max_iters=max_iters)
            q, _, info_f = self.solve_fwd_warm(level, w_f, p_c, lam_c=lam_c, max_iters=max_iters)
            return q, qc, info_f, info_c
        qc, _, info_c, p_c = self.solve_fwd(level + 1, w_c, return_pressure=True,
                                            max_iters=max_iters)
        q, _, info_f = self.solve_fwd_warm(level, w_f, p_c, max_iters=max_iters)
        return q, qc, info_f, info_c

    def _preconditioner(self, L: DarcyLevel, w: torch.Tensor, mass_fac):
        """r -> z ~ S(w)^{-1} r for this solve (see the module docstring)."""
        cfg = self.solver_cfg
        if L.coef_mg is not None:
            # Per-sample Galerkin MG: its whole coefficient dependence is
            # the masked mass-diagonal inverse, set up once per solve.
            diag_w = L.mass_solver.masked_diag(mass_fac, w.shape[:-1])
            pos = diag_w > 0
            dinv0 = torch.where(pos, 1.0 / torch.where(pos, diag_w, torch.ones_like(diag_w)),
                                torch.zeros_like(diag_w))
            state = struct_mg_setup(L.coef_mg, dinv0)
            pdt = _PREC_DTYPES.get(getattr(cfg, "coefmg_prec_dtype", "") or "")
            nsw = max(1, int(getattr(cfg, "coefmg_sweeps", 2)))
            mg = L.coef_mg
            if pdt is None:
                cycle = lambda r: struct_v_cycle(mg, state, r, sweeps=nsw)
            else:
                # Reduced-precision preconditioner state: the V-cycle runs
                # in pdt, the CG in the solve dtype.
                state = cast_state(state, pdt)
                cycle = lambda r: struct_v_cycle(mg, state, r.to(pdt), sweeps=nsw).to(r.dtype)
            ncyc = max(1, int(getattr(cfg, "coefmg_cycles", 1)))
            if ncyc == 1:
                return cycle

            def composed(r):
                # z_{k+1} = z_k + V(r - S z_k): a fixed symmetric polynomial
                # in the MG's own face-form operator (CG-safe).
                z = cycle(r)
                for _ in range(ncyc - 1):
                    z = z + cycle(r - struct_s_apply(mg, state, z))
                return z

            return composed
        if cfg.local_schur_scaling:
            # S(w)^{-1} ~ diag(w)^{1/2} S(1)^{-1} diag(w)^{1/2}.
            sw = torch.sqrt(w)
            return lambda r: sw * tensor_solve(L.schur, sw * r)
        # S(w)^{-1} ~ w_bar S(1)^{-1}, w_bar the per-sample geometric mean.
        w_bar = torch.exp(torch.mean(torch.log(w), dim=-1, keepdim=True))
        return lambda r: w_bar * tensor_solve(L.schur, r)

    def _solve_cg_schur(self, L: DarcyLevel, w: torch.Tensor, return_pressure: bool,
                        x0: Optional[torch.Tensor] = None, lam0: Optional[torch.Tensor] = None,
                        return_adjoint: bool = False, max_iters: Optional[int] = None):
        cfg = self.solver_cfg
        adjoint = bool(getattr(cfg, "adjoint_qoi", False))
        if return_adjoint and not adjoint:
            raise ValueError("return_adjoint requires config.adjoint_qoi")
        batch = w.shape[:-1]
        f = L.rhs[: L.n_u].expand(batch + (L.n_u,))
        g = L.rhs[L.n_u:].expand(batch + (L.n_s,))
        # Factor the tridiagonal mass tables once per solve.
        mass_fac = L.mass_solver.factor(w)
        Minv = lambda r: L.mass_solver.apply_factored(mass_fac, r)
        rhs_s = self._apply_B(L, Minv(f)) - g
        prec = self._preconditioner(L, w, mass_fac)
        apply_S = lambda p: self._apply_B(L, Minv(self._apply_Bt(L, p)))
        krylov = dict(
            prec=prec,
            max_iters=cfg.max_iterations if max_iters is None else int(max_iters),
            rtol=cfg.relative_tolerance,
            atol=cfg.absolute_tolerance,
            restart_every=cfg.restart_every,
        )
        # want_r_true on the adjoint path: the correction consumes the
        # primal true residual, which pcg's exit check computes anyway.
        out = pcg(apply_S, rhs_s, x0=(-x0 if x0 is not None else None),  # p~ = -p
                  want_r_true=adjoint, **krylov)
        p, info = out[0], out[1]
        u = Minv(f - self._apply_Bt(L, p))
        Q = torch.sum(p * L.obs_func[L.n_u:], dim=-1) + torch.sum(
            u * L.obs_func[: L.n_u], dim=-1
        )
        lam = None
        if adjoint:
            # Goal-oriented correction: with q_s = dQ/dp = c_p - B M(w)^{-1} c_u
            # the QoI reduced to pressure space, solve S lam = q_s and add
            # lam^T r (r the primal true residual); the remaining QoI error
            # is the product of the two solves' energy errors.
            cu = L.obs_func[: L.n_u].expand(batch + (L.n_u,))
            q_s = L.obs_func[L.n_u:] - self._apply_B(L, Minv(cu))
            lam, info_a = pcg(apply_S, q_s, x0=lam0, **krylov)
            Q = Q + torch.sum(lam * out[2], dim=-1)
            info = SolveInfo(info.iterations + info_a.iterations,
                             torch.maximum(info.residual, info_a.residual),
                             info.converged & info_a.converged)
        cost = float(L.n_u + L.n_s)
        if return_adjoint:
            return Q, cost, info, -p, lam
        if return_pressure:
            return Q, cost, info, -p
        return Q, cost, info
