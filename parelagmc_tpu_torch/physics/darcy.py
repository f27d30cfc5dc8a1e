"""Mixed Darcy forward model with per-sample permeability.

Port of parelagmc_tpu/physics/darcy.py (see the reference's docstring for
the formulation). Per realization of the coefficient w, solve

    [[M(w), B^T], [B, 0]] [u; p~] = [f; g]      (p~ = -p convention)

either by CG on the pressure Schur complement S(w) = B M(w)^{-1} B^T, with
M(w)^{-1} applied exactly by batched tridiagonal line solves
(ops/mass_solve.py, kernel K1), or by MINRES on the saddle system.
Solvers and preconditioners, by config.darcy_solver.name:

* "cg-schur": without a kinv_ref the exact reference-coefficient inverse
  S(1)^{-1} (tensor spectral solver), scaled by the per-sample geometric
  mean of w or, with `local_schur_scaling`, symmetrically by sqrt(w) per
  cell; with a kinv_ref the static geometric multigrid on
  S_bar = B diag(M(1; kinv))^{-1} B^T (ops/multigrid.py, optionally with
  line smoothing on K1: `mg_line_smoother`), scaled the same two ways;
* "cg-schur-diag": diag(S_bar)^{-1} under a kinv_ref;
* "cg-schur-exact": S(1)^{-1} under a kinv_ref, scaled by the geometric
  mean of w * kinv or, with `local_schur_scaling`, by sqrt(w * kinv) per
  cell;
* "cg-schur-coefmg": the per-sample Galerkin Schur multigrid, rebuilt from
  this sample's masked mass diagonal: the slicing form on tensor meshes
  (ops/coef_multigrid_structured.py; on a card its cycle replays as a CUDA
  graph from a shape's second solve on) or, with coefmg_impl="gather", the
  generic gather form (ops/coef_multigrid.py); optionally with a bfloat16
  state (`coefmg_prec_dtype`), composed cycles and line smoothing on K1;
* "minres-bj": block-diagonal preconditioned MINRES on the saddle system
  (diag M(w)^{-1} and the scaled S(1)^{-1}), the independent oracle of the
  Schur-CG family. It has no warm start and no adjoint path.

A static inverse permeability `kinv_ref` on the finest mesh enters every
level's M(w): by default through the energy-consistent Galerkin blocks of
fem/galerkin_mass.py (rhs and QoI restricted through the matching adapted
RT embedding), or rediscretized by volume averaging
(config.coarse_operators="rediscretize").

QoI functionals (eff_perm, p_int, local_avg_p) are assembled on the finest
level and restricted through P^T exactly like the reference; `adjoint_qoi`
adds the goal-oriented correction lam^T r from a second (adjoint) Schur
solve - sequential, or with `adjoint_stacked` as one CG over a
right-hand-side axis at -2, every M(w)^{-1} apply solving both vectors on
one read of the sample's tables - and `meanfield_x0` starts every cold
solve from a cached w = 1 solution.

With `spatial_shards` > 1 the finest level's Schur CG runs sharded into
y-slabs (parallel/spatial_darcy.SpatialDarcy; `spatial_sample_shards`
splits the batch into sample rows as well): in this process with the slabs
stacked on one device, or one slab per rank when a torch.distributed
process group of spatial_shards * spatial_sample_shards ranks is up.

CPU parity tests: tests/test_torch_darcy.py, tests/test_torch_spe10.py
(every solver name against the JAX package, `device="cpu"`); on the card,
phase 13 of chip_smoke.py drives every solver.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.fem.assembly import build_mixed_level
from parelagmc_tpu_torch.fem.galerkin_mass import (
    blocks_to_ell_vals,
    effective_kinv,
    fine_axis_blocks,
    galerkin_block_chain,
    weighted_rt_prolongator,
)
from parelagmc_tpu_torch.fem.hierarchy import GeometricHierarchy, axis_parent_map, derefine_axis
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.mesh.structured import StructuredMesh
from parelagmc_tpu_torch.ops.coef_multigrid import (
    CoefMG,
    _s_apply,
    build_coef_mg,
    coef_mg_dinvs,
    coef_mg_idiags,
    coef_v_cycle,
    in_precision,
)
from parelagmc_tpu_torch.ops.coef_multigrid_structured import (
    VCycleGraphs,
    build_struct_coef_mg,
    cast_state,
    parse_line_axes,
    struct_mg_setup,
    struct_s_apply,
)
from parelagmc_tpu_torch.ops.ell import (
    CoefELL,
    DiagCoef,
    coef_diag_structure,
    coef_ell_apply,
    pack_coef_ell,
)
from parelagmc_tpu_torch.ops.mass_solve import MassTridiagSolver, build_mass_tridiag_solver
from parelagmc_tpu_torch.ops.multigrid import MGHierarchy, build_mg_hierarchy, v_cycle
from parelagmc_tpu_torch.ops.solvers import SolveInfo, minres, pcg
from parelagmc_tpu_torch.ops.tensorsolve import TensorEig, build_tensor_solver, tensor_solve
from parelagmc_tpu_torch.utils import trace

_SOLVERS = ("cg-schur", "cg-schur-diag", "cg-schur-exact", "cg-schur-coefmg", "minres-bj")
_PREC_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64}
# The meanfield setup solve may continue through up to this many bounded
# executions of max_iterations each in the reference
# (parelagmc_tpu/physics/darcy.py:797); here
# it is one solve with that total budget.
_MEANFIELD_SEGMENTS = 16


class DarcyLevel(nn.Module):
    """Device operators of one level."""

    def __init__(self, n_u: int, n_s: int, rhs: torch.Tensor, obs_func: torch.Tensor, schur: TensorEig,
                 mass_solver: MassTridiagSolver, shape, face_offsets, b_masks,
                 coef_mg=None, ess: Optional[torch.Tensor] = None,
                 m_op: Optional[CoefELL] = None, m_diag: Optional[DiagCoef] = None,
                 kinv_logmean: float = 0.0, kinv_cell: Optional[torch.Tensor] = None,
                 sbar_dinv: Optional[torch.Tensor] = None,
                 schur_mg: Optional[MGHierarchy] = None):
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
        # Per-sample Galerkin Schur MG (cg-schur-coefmg): the StructCoefMG
        # of tensor meshes or the gather-form CoefMG.
        self.coef_mg = coef_mg
        self.register_buffer("ess", ess)  # (n_u,) bool
        # The saddle-system (minres-bj) operators; None for the Schur-CG
        # family, which inverts M(w) by line solves, never applies the
        # assembled mass and reads its diagonal off the factor tables
        # (MassTridiagSolver.masked_diag equals m_diag(w)).
        self.m_op = m_op  # masked velocity mass ELL (ess rows/cols zeroed)
        self.m_diag = m_diag  # its masked diagonal structure
        self.kinv_logmean = float(kinv_logmean)  # log geometric mean of kinv (0 if none)
        self.register_buffer("kinv_cell", kinv_cell)  # (n_s,) per-cell geomean of kinv, or None
        self.register_buffer("sbar_dinv", sbar_dinv)  # (n_s,) 1 / diag(S_bar) (cg-schur-diag)
        self.schur_mg = schur_mg  # static kinv-aware Schur MG ("cg-schur" with a kinv_ref)

    @property
    def b_masks(self):
        return tuple(getattr(self, f"b_mask{a}") for a in range(len(self.shape)))


def _assemble_sbar(mesh, kinv, ess_attr):
    """Static variable-coefficient pressure Schur complement
    S_bar = B diag(M(1; kinv))^{-1} B^T as scipy CSR (the sample field w is
    a bounded lognormal multiplier on top of kinv, so S_bar captures the
    dominant coefficient contrast)."""
    lvl = build_mixed_level(mesh)
    d = mesh.dim
    ess = lvl.ess_faces(np.asarray(ess_attr[: 2 * d], dtype=np.int64))
    face_ax = mesh.face_axis()
    mv = lvl.m_vals * kinv[lvl.m_cells, face_ax[:, None]]
    diag = mv[:, 0] + mv[:, 1]  # diag slots are first two by construction
    dinv = np.where(ess | (diag <= 0), 0.0, 1.0 / np.maximum(diag, 1e-300))
    signs = np.where(ess[lvl.cell_faces], 0.0, lvl.cell_signs)
    rows = np.repeat(np.arange(lvl.n_s), lvl.cell_faces.shape[1])
    B = sp.csr_matrix((signs.ravel(), (rows, lvl.cell_faces.ravel())), shape=(lvl.n_s, lvl.n_u))
    return (B @ sp.diags(dinv) @ B.T).tocsr()


def _build_schur_mg(mesh, kinv, ess_attr, dtype, cutoff: int, coarse_sweeps: int = 0,
                    line_smoother: bool = False, device=None) -> MGHierarchy:
    """Geometric multigrid hierarchy on S_bar: derefine below the MLMC level
    as far as needed, rediscretizing the coefficient by volume-weighted
    averaging, until the coarsest grid is dense-invertible."""
    meshes = [mesh]
    kinvs = [np.asarray(kinv, dtype=np.float64)]
    ps = []
    while meshes[-1].num_cells > cutoff and max(meshes[-1].shape) > 2:
        prev = meshes[-1]
        coarse = StructuredMesh([derefine_axis(a) for a in prev.axes])
        maps = [axis_parent_map(prev.axes[a], coarse.axes[a]) for a in range(prev.dim)]
        idx = prev.cell_multi_index()
        par = coarse.cell_index(*[m[i] for m, i in zip(maps, idx)])
        acc = np.zeros((coarse.num_cells, kinvs[-1].shape[1]))
        np.add.at(acc, par, prev.cell_volumes()[:, None] * kinvs[-1])
        kinvs.append(acc / coarse.cell_volumes()[:, None])
        meshes.append(coarse)
        ps.append(sp.csr_matrix((np.ones(prev.num_cells), (np.arange(prev.num_cells), par)),
                                shape=(prev.num_cells, coarse.num_cells)))
    mats = [_assemble_sbar(m, k, ess_attr) for m, k in zip(meshes, kinvs)]
    return build_mg_hierarchy(mats, ps, dtype, coarse_sweeps=coarse_sweeps,
                              line_shapes=[m.shape for m in meshes] if line_smoother else None,
                              device=device)


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


def _rows(w: torch.Tensor) -> int:
    """The systems a batch of coefficient fields (..., n_s) poses."""
    return w.numel() // max(1, w.shape[-1])


def _check_config(config: ProblemConfig) -> None:
    cfg = config.darcy_solver
    if cfg.name not in _SOLVERS:
        raise ValueError(f"darcy solver {cfg.name!r}: expected one of {_SOLVERS}")
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
        _check_config(config)
        self.hierarchy = hierarchy
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.solver_cfg = config.darcy_solver
        self._mf_cache = {}  # per-level mean-field iterates (meanfield_x0)
        # The structured coefMG's cycles as CUDA graphs, by shape: here, so
        # they outlive the managers that solve through this solver.
        self._vcycle_graphs = VCycleGraphs()
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
        # The assembled mass ELL is only applied by the saddle-system
        # (minres-bj) path; the Schur-CG family never needs it on the device.
        need_m_op = not cfg.name.startswith("cg-schur")
        levels = []
        self._nnz: List[int] = []
        for l, lvl in enumerate(hierarchy.levels):
            ess = lvl.ess_faces(ess_attr)
            rhs_l = rhs_np[l].copy()
            rhs_l[: lvl.n_u][ess] = 0.0  # zero essential data (reference default)
            kinv = kinv_levels[l]
            # Masked mass values in the coefficient-ELL slot layout.
            if blocks_chain is not None:
                m_vals = blocks_to_ell_vals(lvl, blocks_chain[l])
            else:
                m_vals = lvl.m_vals.copy()
                if kinv is not None:
                    m_vals = m_vals * kinv[lvl.m_cells, lvl.mesh.face_axis()[:, None]]
            m_vals[ess, :] = 0.0
            m_vals = np.where(ess[lvl.m_cols], 0.0, m_vals)
            cell_signs = np.where(ess[lvl.cell_faces], 0.0, lvl.cell_signs)
            self._nnz.append(int(np.sum(m_vals != 0)) + 2 * int(np.sum(cell_signs != 0)))
            coef_mg = None
            if cfg.name == "cg-schur-coefmg":
                mg_kw = dict(
                    cutoff=cfg.coarse_dense_cutoff,
                    coarse_sweeps=max(1, cfg.mg_coarse_sweeps),
                    omega=getattr(cfg, "coefmg_omega", 0.8),
                    cheby_order=getattr(cfg, "coefmg_cheby_order", 0),
                    cheby_lo=getattr(cfg, "coefmg_cheby_lo", 0.25),
                )
                if getattr(cfg, "coefmg_impl", "auto") == "gather":
                    # The generic gather tables (the slicing form's oracle).
                    coef_mg = build_coef_mg(lvl.mesh, ess, dtype=dtype, device=dev, **mg_kw)
                else:
                    coef_mg = build_struct_coef_mg(
                        lvl.mesh,
                        line_axes=parse_line_axes(getattr(cfg, "coefmg_line_axes", ""),
                                                  lvl.mesh, kinv),
                        line_omega=getattr(cfg, "coefmg_line_omega", 1.0),
                        coarsen=getattr(cfg, "coefmg_coarsen", "galerkin"),
                        **mg_kw,
                    )
            schur_mg = sbar_dinv = kinv_cell = None
            kinv_logmean = 0.0
            if kinv is not None:
                log_kinv = np.log(np.maximum(kinv, 1e-300))
                kinv_logmean = float(np.mean(log_kinv))
                kinv_cell = as_t(np.exp(np.mean(log_kinv, axis=1)))
                if cfg.name == "cg-schur":
                    schur_mg = _build_schur_mg(
                        lvl.mesh, kinv, ess_attr, dtype,
                        config.sampler_solver.coarse_dense_cutoff,
                        coarse_sweeps=cfg.mg_coarse_sweeps,
                        line_smoother=cfg.mg_line_smoother, device=dev)
                elif cfg.name == "cg-schur-diag":
                    sbar = _assemble_sbar(lvl.mesh, kinv, ess_attr).diagonal()
                    sbar_dinv = as_t(1.0 / np.maximum(sbar, 1e-300))
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
                    ess=as_t(ess, torch.bool),
                    m_op=(pack_coef_ell(lvl.m_cols, m_vals, lvl.m_cells, dtype, device=dev)
                          if need_m_op else None),
                    m_diag=(coef_diag_structure(lvl.m_cols, m_vals, lvl.m_cells, dtype,
                                                device=dev) if need_m_op else None),
                    kinv_logmean=kinv_logmean,
                    kinv_cell=kinv_cell,
                    sbar_dinv=sbar_dinv,
                    schur_mg=schur_mg,
                )
            )
        self.levels = nn.ModuleList(levels)
        self.kinv_levels = kinv_levels  # host copies, per level (None without kinv_ref)
        self._blocks_chain = blocks_chain
        self._ess_attr = ess_attr
        # Parent cell maps for the warm-started pair solves (coarse -> fine
        # piecewise-constant pressure prolongation).
        self._parent = [as_t(p, torch.int64) for p in hierarchy.parent]
        # Spatially sharded solvers of config spatial_shards, built at first use.
        self._spatial_cache: Dict[tuple, object] = {}
        n_spatial = int(getattr(cfg, "spatial_shards", 0) or 0)
        if n_spatial > 1 and cfg.name == "minres-bj":
            # Falling back to the replicated solve would defeat the reason
            # spatial_shards exists (a device's memory at SPE10 scale).
            raise ValueError("spatial_shards requires a cg-schur-family solver; "
                             "minres-bj solves the full saddle system replicated")
        if int(getattr(cfg, "spatial_sample_shards", 1) or 1) > 1 and n_spatial <= 1:
            warnings.warn("spatial_sample_shards > 1 has no effect without spatial_shards > 1 "
                          "(no (dp, sp) sharding is built)", stacklevel=2)

    def level_blocks(self, level: int):
        """Per-(cell, axis) mass blocks (bll, blr, brr) of the level: the
        complete kinv-bearing coefficient structure of M(w)."""
        if self._blocks_chain is not None:
            return self._blocks_chain[level]
        return fine_axis_blocks(self.hierarchy.levels[level].mesh, self.kinv_levels[level])

    def sbar_diag_np(self, level: int) -> np.ndarray:
        """Host copy of diag(S_bar) at the level (Jacobi-preconditioner data)."""
        lvl = self.hierarchy.levels[level]
        kinv = self.kinv_levels[level]
        if kinv is None:
            kinv = np.ones((lvl.n_s, lvl.dim))
        return np.maximum(_assemble_sbar(lvl.mesh, kinv, self._ess_attr).diagonal(), 1e-300)

    # -- public API ------------------------------------------------------------
    def num_dofs(self, level: int) -> int:
        L = self.levels[level]
        return L.n_u + L.n_s

    def nnz(self, level: int) -> int:
        return self._nnz[level]

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
        with the coarse adjoint warm-starting the fine one? False under
        minres-bj (the saddle-system MINRES has no Schur adjoint path)."""
        return (bool(getattr(self.solver_cfg, "adjoint_qoi", False))
                and self.solver_cfg.name != "minres-bj")

    def solve_fwd(self, level: int, w: torch.Tensor, return_pressure: bool = False,
                  return_adjoint: bool = False, max_iters: Optional[int] = None,
                  rtol: Optional[float] = None):
        """Solve for a batch of coefficient fields w (..., n_s). Returns
        (Q, cost, info[, p[, lam]]) with p the physical pressure and lam the
        adjoint (return_adjoint, needs config.adjoint_qoi). With
        config.meanfield_x0 the solve starts from the cached w = 1 solution.
        `max_iters` overrides config.max_iterations for this solve. `rtol`,
        where it is below config.relative_tolerance, is the primal solve's
        tolerance for this call (the pressure itself, not only Q, to that
        tolerance); the adjoint keeps the configuration's, and the primal
        iterations run past the configuration's tolerance count in
        `krylov.extra_iterations` (ops/solvers.pcg; not on the spatially
        sharded solve, which counts no Krylov iterations)."""
        if rtol is not None and rtol >= self.solver_cfg.relative_tolerance:
            rtol = None
        with trace.span("darcy.solve", level=level, rows=_rows(w), start="cold") as sp:
            if self._use_spatial(level):
                return self._solve_spatial(level, w, return_pressure,
                                           return_adjoint=return_adjoint, max_iters=max_iters,
                                           rtol=rtol)
            if self.solver_cfg.name == "minres-bj":
                if getattr(self.solver_cfg, "adjoint_qoi", False):
                    raise NotImplementedError("adjoint_qoi applies to the cg-schur solver family")
                return self._solve_minres(self.levels[level], w, return_pressure, max_iters,
                                          rtol=rtol)
            x0 = lam0 = None
            if getattr(self.solver_cfg, "meanfield_x0", False):
                sp.note("start", "mean-field")
                p_ref, lam_ref = self._meanfield_start(level)
                batch = w.shape[:-1]
                x0 = p_ref.expand(batch + p_ref.shape[-1:])
                if lam_ref is not None:
                    lam0 = lam_ref.expand(batch + lam_ref.shape[-1:])
            return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=x0, lam0=lam0,
                                        return_adjoint=return_adjoint, max_iters=max_iters,
                                        rtol=rtol)

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
        parent's value (P0 prolongation). minres-bj has no warm start: it
        solves cold."""
        if self.solver_cfg.name == "minres-bj":
            return self.solve_fwd(level, w, return_pressure=return_pressure, max_iters=max_iters)
        with trace.span("darcy.solve", level=level, rows=_rows(w), start="warm"):
            p0 = torch.index_select(p_coarse, -1, self._parent[level])
            lam0 = (torch.index_select(lam_c, -1, self._parent[level]) if lam_c is not None
                    else None)
            if self._use_spatial(level):
                return self._solve_spatial(level, w, return_pressure, p0=p0, lam0=lam0,
                                           return_adjoint=return_adjoint, max_iters=max_iters)
            return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=p0,
                                        lam0=lam0, return_adjoint=return_adjoint,
                                        max_iters=max_iters)

    def solve_fwd_x0(self, level: int, w: torch.Tensor, p0: torch.Tensor,
                     return_pressure: bool = False, lam0: Optional[torch.Tensor] = None,
                     return_adjoint: bool = False, max_iters: Optional[int] = None):
        """Continue or restart the level solve from a SAME-level physical
        pressure iterate p0 (and adjoint iterate lam0). Kept for parity with
        the reference's API, whose examples continue solves with it; no
        path of this package calls it (MLMCManager runs each pair solve
        composed instead). minres-bj solves cold."""
        if self.solver_cfg.name == "minres-bj":  # never spatial (_use_spatial)
            return self.solve_fwd(level, w, return_pressure=return_pressure, max_iters=max_iters)
        with trace.span("darcy.solve", level=level, rows=_rows(w), start="warm"):
            if self._use_spatial(level):
                return self._solve_spatial(level, w, return_pressure, p0=p0, lam0=lam0,
                                           return_adjoint=return_adjoint, max_iters=max_iters)
            return self._solve_cg_schur(self.levels[level], w, return_pressure, x0=p0,
                                        lam0=lam0, return_adjoint=return_adjoint,
                                        max_iters=max_iters)

    # -- spatial domain decomposition (config spatial_shards) ------------------
    def _use_spatial(self, level: int) -> bool:
        """Route this level through the spatially sharded solver? The finest
        level only (where a device's memory binds), never under minres-bj."""
        return (int(getattr(self.solver_cfg, "spatial_shards", 0) or 0) > 1 and level == 0
                and self.solver_cfg.name != "minres-bj")

    def _spatial(self, level: int):
        """The SpatialDarcy of this level, built at first use: cg-schur-coefmg
        gets the two-level Schwarz slab coefMG, the other cg-schur variants
        sqrt(w)-scaled diag(S_bar) Jacobi. Cached on every config field it
        bakes in, so `solver.solver_cfg = dataclasses.replace(...)` rebuilds
        it instead of answering with the old settings (the reference's key
        leaves out coarse_dense_cutoff and mg_coarse_sweeps). A solve's
        max_iters override reaches the sharded solve without a rebuild."""
        cfg = self.solver_cfg
        n_sp = int(cfg.spatial_shards)
        n_dp = int(getattr(cfg, "spatial_sample_shards", 1) or 1)
        key = (level, cfg.name, n_sp, n_dp, float(cfg.relative_tolerance),
               int(cfg.max_iterations), int(getattr(cfg, "restart_every", 50) or 0),
               getattr(cfg, "coefmg_prec_dtype", ""), int(getattr(cfg, "coefmg_cycles", 1)),
               int(getattr(cfg, "coefmg_cheby_order", 0)),
               float(getattr(cfg, "coefmg_cheby_lo", 0.25)), int(getattr(cfg, "coefmg_sweeps", 2)),
               float(getattr(cfg, "coefmg_omega", 0.8)), getattr(cfg, "coefmg_line_axes", ""),
               float(getattr(cfg, "coefmg_line_omega", 1.0)),
               getattr(cfg, "coefmg_coarsen", "galerkin"), int(cfg.coarse_dense_cutoff),
               int(cfg.mg_coarse_sweeps))
        if key not in self._spatial_cache:
            from parelagmc_tpu_torch.parallel.spatial_darcy import SpatialDarcy

            self._spatial_cache[key] = SpatialDarcy.from_darcy(self, level, n_sp=n_sp, n_dp=n_dp)
        return self._spatial_cache[key]

    def _solve_spatial(self, level: int, w: torch.Tensor, return_pressure: bool, p0=None,
                       lam0=None, return_adjoint: bool = False, max_iters: Optional[int] = None,
                       rtol: Optional[float] = None):
        """(Q, cost, info[, p[, lam]]) of the sharded solve: rel and conv from
        its verified exit; with adjoint_qoi rel is the max of the primal and
        adjoint solves', conv their AND and the iterations their sum. `rtol`
        as in solve_fwd: the primal's tolerance for this call."""
        adjoint = bool(getattr(self.solver_cfg, "adjoint_qoi", False))
        if return_adjoint and not adjoint:
            raise ValueError("return_adjoint requires config.adjoint_qoi")
        out = self._spatial(level).solve_fwd(
            w, p0=p0, return_pressure=return_pressure or return_adjoint, lam0=lam0,
            adjoint=adjoint, max_iters=max_iters, rtol=rtol)
        q, it, rel, conv = out[:4]
        info = SolveInfo(int(it.max()), rel, conv)
        cost = float(self.num_dofs(level))
        if return_adjoint:
            return q, cost, info, out[4], out[5]
        if return_pressure:
            return q, cost, info, out[4]
        return q, cost, info

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
        """r -> z ~ S(w)^{-1} r for this solve, in the reference's order of
        precedence (see the module docstring). w is (batch..., n_s), or
        (batch..., 1, n_s) for the stacked solve: every per-sample table
        then carries the singleton right-hand-side axis and broadcasts over
        it, so both systems read it once."""
        cfg = self.solver_cfg
        if L.coef_mg is not None:
            # Per-sample Galerkin MG: its whole coefficient dependence is
            # the masked mass-diagonal inverse, set up once per solve.
            diag_w = L.mass_solver.masked_diag(mass_fac, w.shape[:-1])
            pos = diag_w > 0
            dinv0 = torch.where(pos, 1.0 / torch.where(pos, diag_w, torch.ones_like(diag_w)),
                                torch.zeros_like(diag_w))
            pdt = _PREC_DTYPES.get(getattr(cfg, "coefmg_prec_dtype", "") or "")
            nsw = max(1, int(getattr(cfg, "coefmg_sweeps", 2)))
            mg = L.coef_mg
            if isinstance(mg, CoefMG):
                dinvs = coef_mg_dinvs(mg, dinv0)
                idiags = coef_mg_idiags(mg, dinvs)
                if pdt is not None:
                    # The state in pdt; the index tables stay as they are.
                    dinvs = [t.to(pdt) for t in dinvs]
                    idiags = [t.to(pdt) for t in idiags]
                v = lambda r: coef_v_cycle(mg, dinvs, r, nsw, idiags=idiags)
                # Reduced-precision preconditioner state: the V-cycle runs
                # in pdt, the CG in the solve dtype.
                cycle = lambda r: in_precision(v, r, pdt)
                s_fine = lambda z: _s_apply(mg.levels[0], dinvs[0], z)
            else:
                state = struct_mg_setup(mg, dinv0)
                if pdt is not None:
                    state = cast_state(state, pdt)
                # The same cycle (in pdt, back in the solve dtype), replayed
                # as a CUDA graph on a card from the shape's second solve.
                cycle = self._vcycle_graphs.cycle(mg, state, nsw, pdt)
                s_fine = lambda z: struct_s_apply(mg, state, z)
            ncyc = max(1, int(getattr(cfg, "coefmg_cycles", 1)))
            if ncyc == 1:
                return cycle

            def composed(r):
                # z_{k+1} = z_k + V(r - S z_k): a fixed symmetric polynomial
                # in the MG's own face-form operator (CG-safe).
                z = cycle(r)
                for _ in range(ncyc - 1):
                    z = z + cycle(r - s_fine(z))
                return z

            return composed
        geomean = lambda shift: torch.exp(torch.mean(torch.log(w), dim=-1, keepdim=True) + shift)
        if L.sbar_dinv is not None:
            # Diagonal of the static variable-coefficient Schur complement.
            w_bar = geomean(0.0)
            return lambda r: w_bar * (r * L.sbar_dinv)
        if L.schur_mg is not None:
            # kinv-aware geometric MG on S_bar.
            if cfg.local_schur_scaling:
                # S(w kinv)^{-1} ~ D(w)^{1/2} S(kinv)^{-1} D(w)^{1/2}.
                sw = torch.sqrt(w)
                return lambda r: sw * v_cycle(L.schur_mg, sw * r)
            w_bar = geomean(0.0)
            return lambda r: w_bar * v_cycle(L.schur_mg, r)
        if cfg.local_schur_scaling:
            # S(w)^{-1} ~ diag(w k)^{1/2} S(1)^{-1} diag(w k)^{1/2}, k the
            # per-cell geometric mean of the kinv_ref (1 without one).
            k_loc = L.kinv_cell if L.kinv_cell is not None else math.exp(L.kinv_logmean)
            sw = torch.sqrt(w * k_loc)
            return lambda r: sw * tensor_solve(L.schur, sw * r)
        # S(w)^{-1} ~ w_bar S(1)^{-1}, w_bar the per-sample geometric mean
        # (times the kinv_ref's).
        w_bar = geomean(L.kinv_logmean)
        return lambda r: w_bar * tensor_solve(L.schur, r)

    def _solve_cg_schur(self, L: DarcyLevel, w: torch.Tensor, return_pressure: bool,
                        x0: Optional[torch.Tensor] = None, lam0: Optional[torch.Tensor] = None,
                        return_adjoint: bool = False, max_iters: Optional[int] = None,
                        rtol: Optional[float] = None):
        """The cg-schur family's solve; `rtol` (below the configuration's)
        tightens the primal, or, stacked, both systems."""
        cfg = self.solver_cfg
        adjoint = bool(getattr(cfg, "adjoint_qoi", False))
        stacked = adjoint and bool(getattr(cfg, "adjoint_stacked", False))
        if return_adjoint and not adjoint:
            raise ValueError("return_adjoint requires config.adjoint_qoi")
        batch = w.shape[:-1]
        with trace.span("darcy.setup"):
            f = L.rhs[: L.n_u].expand(batch + (L.n_u,))
            g = L.rhs[L.n_u:].expand(batch + (L.n_s,))
            # Factor the tridiagonal mass tables once per solve.
            mass_fac = L.mass_solver.factor(w)
            Minv = lambda r: L.mass_solver.apply_factored(mass_fac, r)
            rhs_s = self._apply_B(L, Minv(f)) - g
            prec = self._preconditioner(L, w.unsqueeze(-2) if stacked else w, mass_fac)
            if adjoint:
                # q_s = dQ/dp = c_p - B M(w)^{-1} c_u, the QoI reduced to
                # pressure space.
                cu = L.obs_func[: L.n_u].expand(batch + (L.n_u,))
                q_s = L.obs_func[L.n_u:] - self._apply_B(L, Minv(cu))
        # apply_S and prec take (batch..., n_s) and, stacked, (batch..., 2, n_s).
        apply_S = lambda p: self._apply_B(L, Minv(self._apply_Bt(L, p)))
        krylov = dict(
            prec=prec,
            max_iters=cfg.max_iterations if max_iters is None else int(max_iters),
            rtol=cfg.relative_tolerance,
            atol=cfg.absolute_tolerance,
            restart_every=cfg.restart_every,
        )
        primal = krylov if rtol is None else dict(krylov, rtol=rtol,
                                                  loose_rtol=cfg.relative_tolerance)
        lam = None
        if stacked:
            # S [p~, lam] = [rhs_s, q_s] as ONE PCG over a right-hand-side
            # axis at -2: the per-sample state (mass tables, preconditioner
            # hierarchy) is read once per iteration for both systems, rows
            # freeze per (sample, right-hand side), and the loop runs
            # max(it_primal, it_adjoint) trips.
            bb = torch.stack([rhs_s, q_s], dim=-2)
            X0 = None
            if x0 is not None or lam0 is not None:
                X0 = torch.stack([-x0 if x0 is not None else torch.zeros_like(rhs_s),
                                  lam0 if lam0 is not None else torch.zeros_like(q_s)], dim=-2)
            X, info2, R_true = pcg(apply_S, bb, x0=X0, want_r_true=True, role="stacked",
                                   **primal)
            p, lam = X[..., 0, :], X[..., 1, :]
            r_true = R_true[..., 0, :]
            # 2 x iterations: operator applications per sample, comparable
            # with the sequential it_primal + it_adjoint.
            info = SolveInfo(2 * info2.iterations, info2.residual.amax(dim=-1),
                             info2.converged.all(dim=-1))
        else:
            # want_r_true on the adjoint path: the correction consumes the
            # primal true residual, which pcg's exit check computes anyway.
            out = pcg(apply_S, rhs_s, x0=(-x0 if x0 is not None else None),  # p~ = -p
                      want_r_true=adjoint, **primal)
            p, info = out[0], out[1]
            r_true = out[2] if adjoint else None
        u = Minv(f - self._apply_Bt(L, p))
        Q = torch.sum(p * L.obs_func[L.n_u:], dim=-1) + torch.sum(
            u * L.obs_func[: L.n_u], dim=-1
        )
        if adjoint and not stacked:
            # Goal-oriented correction: solve S lam = q_s and add lam^T r
            # (r the primal true residual); the remaining QoI error is the
            # product of the two solves' energy errors.
            lam, info_a = pcg(apply_S, q_s, x0=lam0, role="adjoint", **krylov)
            info = SolveInfo(info.iterations + info_a.iterations,
                             torch.maximum(info.residual, info_a.residual),
                             info.converged & info_a.converged)
        if adjoint:
            Q = Q + torch.sum(lam * r_true, dim=-1)
        cost = float(L.n_u + L.n_s)
        if return_adjoint:
            return Q, cost, info, -p, lam
        if return_pressure:
            return Q, cost, info, -p
        return Q, cost, info

    # -- the saddle system (minres-bj) ----------------------------------------
    def _apply_A(self, L: DarcyLevel, w: torch.Tensor):
        """x -> [[M(w), B^T], [B, 0]] x with identity rows at essential
        dofs; B and B^T by the slicing stencils."""

        def apply_A(x: torch.Tensor) -> torch.Tensor:
            u, p = x[..., : L.n_u], x[..., L.n_u:]
            yu = coef_ell_apply(L.m_op, w, u) + self._apply_Bt(L, p)
            yu = torch.where(L.ess, u, yu)
            return torch.cat([yu, self._apply_B(L, u)], dim=-1)

        return apply_A

    def _prec(self, L: DarcyLevel, w: torch.Tensor):
        """The block-diagonal SPD preconditioner diag(diag(M(w))^{-1},
        w_bar S(1)^{-1}), w_bar the geometric mean of w (times the
        kinv_ref's)."""
        dM = L.m_diag(w)
        inv_dM = 1.0 / torch.where(L.ess, torch.ones_like(dM), dM)
        w_bar = torch.exp(torch.mean(torch.log(w), dim=-1, keepdim=True) + L.kinv_logmean)

        def prec(r: torch.Tensor) -> torch.Tensor:
            ru, rp = r[..., : L.n_u], r[..., L.n_u:]
            return torch.cat([ru * inv_dM, w_bar * tensor_solve(L.schur, rp)], dim=-1)

        return prec

    def _solve_minres(self, L: DarcyLevel, w: torch.Tensor, return_pressure: bool,
                      max_iters: Optional[int] = None, rtol: Optional[float] = None):
        cfg = self.solver_cfg
        b = L.rhs.expand(w.shape[:-1] + L.rhs.shape)
        x, info = minres(
            self._apply_A(L, w), b, prec=self._prec(L, w),
            max_iters=cfg.max_iterations if max_iters is None else int(max_iters),
            rtol=cfg.relative_tolerance if rtol is None else rtol, atol=cfg.absolute_tolerance)
        Q = torch.sum(x * L.obs_func, dim=-1)
        cost = float(L.n_u + L.n_s)
        if return_pressure:
            return Q, cost, info, -x[..., L.n_u:]  # physical pressure p = -p~
        return Q, cost, info
