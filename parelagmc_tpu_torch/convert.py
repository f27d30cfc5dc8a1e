"""Converters from the JAX package's operator objects to the port's.

Duck-typed: they read the JAX objects' fields and call np.asarray on their
arrays, so this module imports no jax. The tests use them to hold the
port's own build functions against the reference's arrays, and to run both
packages on identical operators. `device` None means cuda:0, as at every
entry point of the port. The unstructured host records (GeneralMesh,
SimplicialLevel, AgglomeratedLevel, SimplicialHierarchy) convert field by
field into the port's dataclasses of the same names; `host_record_copy`
does the same into any dataclass, so a test can hand the JAX package a
hierarchy the port built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.fem.agglomeration import AgglomeratedLevel
from parelagmc_tpu_torch.fem.simplicial import SimplicialLevel
from parelagmc_tpu_torch.fem.simplicial_hierarchy import SimplicialHierarchy
from parelagmc_tpu_torch.mesh.mfem_io import GeneralMesh
from parelagmc_tpu_torch.ops import coef_multigrid as tcmg
from parelagmc_tpu_torch.ops import multigrid as tmg
from parelagmc_tpu_torch.ops.coef_multigrid_structured import StructCoefMG, StructMGLevel
from parelagmc_tpu_torch.ops.ell import ELL, CoefELL, DiagCoef
from parelagmc_tpu_torch.ops.mass_solve import AxisTables, MassTridiagSolver
from parelagmc_tpu_torch.ops.tensorsolve import TensorEig
from parelagmc_tpu_torch.physics.darcy import DarcyLevel
from parelagmc_tpu_torch.physics.hybrid import HybridLevel
from parelagmc_tpu_torch.samplers import kl as tkl
from parelagmc_tpu_torch.samplers import pde as tpde


def _t(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=resolve_device(device))


def tensor_eig_from_jax(eig, dtype=torch.float64, device=None) -> TensorEig:
    """parelagmc_tpu.ops.tensorsolve.TensorEig -> port TensorEig."""
    return TensorEig(
        V=[_t(v, dtype, device) for v in eig.V],
        lam=_t(eig.lam, dtype, device),
        w_sqrt=_t(eig.w_sqrt, dtype, device),
        shape=tuple(eig.shape),
    )


def mass_solver_from_jax(ms, dtype=torch.float64, device=None) -> MassTridiagSolver:
    """parelagmc_tpu.ops.mass_solve.MassTridiagSolver -> port solver. The
    reference holds each axis transposed with the solved axis LAST
    (perm_cell = other dims + (axis,)); the port holds the natural (z, y, x)
    grids, so the transpose is undone."""
    axes = []
    for ax in ms.axes:
        if tuple(ax.perm_face) != tuple(ax.perm_cell):
            raise ValueError("perm_face != perm_cell is not supported")
        natural = lambda x: np.transpose(np.asarray(x), np.argsort(ax.perm_cell))
        axes.append(
            AxisTables(
                m_lo=_t(natural(ax.m_lo), dtype, device),
                m_mid=_t(natural(ax.m_mid), dtype, device),
                m_hi=_t(natural(ax.m_hi), dtype, device),
                ess=_t(natural(ax.ess), torch.bool, device),
                n_a=ax.n_a,
                dim=ax.perm_cell[-1],
            )
        )
    return MassTridiagSolver(axes, tuple(ms.shape), tuple(ms.face_offsets), ms.n_u)


def struct_coef_mg_from_jax(mg) -> StructCoefMG:
    """parelagmc_tpu.ops.coef_multigrid_structured.StructCoefMG -> port."""
    return StructCoefMG(
        levels=tuple(StructMGLevel(tuple(l.shape), tuple(l.fine_shape)) for l in mg.levels),
        face_offsets=tuple(mg.face_offsets), omega=mg.omega, coarse_sweeps=mg.coarse_sweeps,
        cheby_order=mg.cheby_order, cheby_lo=mg.cheby_lo, line_axes=tuple(mg.line_axes),
        line_omega=mg.line_omega, coarsen=mg.coarsen,
    )


def darcy_level_from_jax(L, dtype=torch.float64, device=None) -> DarcyLevel:
    """parelagmc_tpu.physics.darcy.DarcyLevel (tensor mesh) -> port
    DarcyLevel, with whatever preconditioner state and saddle-system
    operators the reference level carries (m_diag only beside m_op: the
    port's Schur-CG family reads the diagonal off its factor tables)."""
    if L.b_struct is None:
        raise ValueError("only tensor-mesh levels (b_struct set) convert")
    shape, offs, masks = L.b_struct
    opt = lambda x, dt=dtype: None if x is None else _t(x, dt, device)
    coef_mg = L.coef_mg
    if coef_mg is not None:
        coef_mg = (struct_coef_mg_from_jax(coef_mg) if hasattr(coef_mg, "face_offsets")
                   else coef_mg_from_jax(coef_mg, dtype, device))
    return DarcyLevel(
        n_u=L.n_u,
        n_s=L.n_s,
        rhs=_t(L.rhs, dtype, device),
        obs_func=_t(L.obs_func, dtype, device),
        schur=tensor_eig_from_jax(L.schur, dtype, device),
        mass_solver=mass_solver_from_jax(L.mass_solver, dtype, device),
        shape=shape,
        face_offsets=offs,
        b_masks=[_t(m, dtype, device) for m in masks],
        coef_mg=coef_mg,
        ess=_t(L.ess, torch.bool, device),
        m_op=None if L.m_op is None else coef_ell_from_jax(L.m_op, dtype, device),
        m_diag=None if L.m_op is None else diag_coef_from_jax(L.m_diag, dtype, device),
        kinv_logmean=L.kinv_logmean,
        kinv_cell=opt(L.kinv_cell),
        sbar_dinv=opt(L.sbar_dinv),
        schur_mg=None if L.schur_mg is None else mg_hierarchy_from_jax(L.schur_mg, dtype, device),
    )


def ell_from_jax(ell, dtype=torch.float64, device=None) -> ELL:
    """parelagmc_tpu.ops.ell.ELL -> port ELL (int32 columns become int64)."""
    return ELL(_t(ell.cols, torch.int64, device), _t(ell.vals, dtype, device))


def coef_ell_from_jax(op, dtype=torch.float64, device=None) -> CoefELL:
    """parelagmc_tpu.ops.ell.CoefELL -> port CoefELL (int64 indices)."""
    return CoefELL(_t(op.cols, torch.int64, device), _t(op.mvals, dtype, device),
                   _t(op.cells, torch.int64, device))


def diag_coef_from_jax(dc, dtype=torch.float64, device=None) -> DiagCoef:
    """parelagmc_tpu.ops.ell.DiagCoef -> port DiagCoef."""
    return DiagCoef(_t(dc.cells, torch.int64, device), _t(dc.vals, dtype, device))


def mg_hierarchy_from_jax(mg, dtype=torch.float64, device=None) -> tmg.MGHierarchy:
    """parelagmc_tpu.ops.multigrid.MGHierarchy -> port MGHierarchy. The
    reference's line tables are (nlines, m) with a line-major gather order;
    the port holds them solved axis first."""
    dev = resolve_device(device)
    levels = []
    for lvl in mg.levels:
        line = None
        if lvl.line is not None:
            line = [tmg.line_smoother_from_host(np.asarray(ln.dl), np.asarray(ln.d),
                                                np.asarray(ln.du), np.asarray(ln.perm),
                                                ln.omega, dtype, dev) for ln in lvl.line]
        levels.append(tmg.MGLevel(
            A=ell_from_jax(lvl.A, dtype, dev), inv_diag=_t(lvl.inv_diag, dtype, dev),
            P=ell_from_jax(lvl.P, dtype, dev), Pt=ell_from_jax(lvl.Pt, dtype, dev), line=line))
    return tmg.MGHierarchy(
        levels=levels, coarse_A=ell_from_jax(mg.coarse_A, dtype, dev),
        coarse_inv=_t(mg.coarse_inv, dtype, dev), omega=mg.omega,
        coarse_inv_diag=_t(mg.coarse_inv_diag, dtype, dev), coarse_sweeps=mg.coarse_sweeps)


def coef_mg_from_jax(mg, dtype=torch.float64, device=None) -> tcmg.CoefMG:
    """parelagmc_tpu.ops.coef_multigrid.CoefMG -> port CoefMG (int64 index
    tables)."""
    dev = resolve_device(device)
    levels = []
    for lvl in mg.levels:
        tables = {name: np.asarray(getattr(lvl, name)) for name in lvl._fields
                  if getattr(lvl, name) is not None}
        levels.append(tcmg._level(dtype, dev, **tables))
    return tcmg.CoefMG(levels, mg.omega, mg.coarse_sweeps, mg.cheby_order, mg.cheby_lo)


def sampler_from_jax(js, hierarchy, config, dtype=torch.float64, device=None,
                     orig_hierarchy=None):
    """A sampler of the JAX package (SPDESampler, EmbeddedSPDESampler,
    L2ProjectionSPDESampler or KLSampler, matched by class name) -> the
    port's sampler of the same name carrying the reference's arrays: eigen
    factors, w_sqrt, restriction matrices, field_scale, selection, the G/Gt
    ELL tables and winv_*, or the KL modes. `hierarchy` is the port's
    hierarchy the sampler solves on (the embedded one for the embedded
    variants, whose `orig_hierarchy` is the original mesh's); it supplies
    the host-side level data only."""
    name = type(js).__name__
    dev = resolve_device(device)
    t = lambda x, dt=dtype: _t(x, dt, dev)
    if name == "KLSampler":
        out = tkl.KLSampler.__new__(tkl.KLSampler)
        out.hierarchy, out.covariance, out.config = hierarchy, js.covariance, config
        out.dtype, out.device = dtype, dev
        out.sigma, out.lognormal, out.nmodes = js.sigma, js.lognormal, js.nmodes
        out.sqrt_theta = t(js.sqrt_theta)
        out.modes = [t(m) for m in js.modes]
        return out
    cls = getattr(tpde, name)
    out = cls.__new__(cls)
    out.hierarchy, out.config, out.dtype, out.device = hierarchy, config, dtype, dev
    for f in ("ndim", "corlen", "alpha", "g", "sigma", "lognormal"):
        setattr(out, f, getattr(js, f))
    out.eigs = [tensor_eig_from_jax(e, dtype, dev) for e in js.eigs]
    out.field_scale = None if js.field_scale is None else [t(x) for x in js.field_scale]
    out.w_sqrt = [t(x) for x in js.w_sqrt]
    out.shapes = [tuple(sh) for sh in js.shapes]
    out.restrict_mats = [tuple(t(m) for m in mats) for mats in js.restrict_mats]
    if name == "SPDESampler":
        out._flux = {}
        return out
    out.orig_hierarchy = orig_hierarchy
    if name == "EmbeddedSPDESampler":
        out.selection = [t(x, torch.int64) for x in js.selection]
    else:
        out.G = [ell_from_jax(e, dtype, dev) for e in js.G]
        out.Gt = [ell_from_jax(e, dtype, dev) for e in js.Gt]
        out.winv_orig = [t(x) for x in js.winv_orig]
        out.winv_embed = [t(x) for x in js.winv_embed]
    return out


def bayes_obs_from_jax(jbip, dtype=torch.float64, device=None):
    """(g_obs per level, G_obs or None) of a JAX BayesianInverseProblem as
    port tensors."""
    g_obs = [_t(g, dtype, device) for g in jbip.g_obs]
    return g_obs, (None if jbip.G_obs is None else _t(jbip.G_obs, dtype, device))


def host_record_copy(obj, cls, **override):
    """`cls` (a dataclass) with the fields of `obj` of the same names:
    arrays copied with np.array, lists of arrays element by element,
    sparse matrices as CSR copies; `override` replaces fields."""
    def copy(v):
        if sp.issparse(v):
            return sp.csr_matrix(v, copy=True)
        if isinstance(v, list):
            return [copy(x) for x in v]
        if isinstance(v, (np.ndarray, np.generic)):
            return np.array(v)
        return v

    kw = {f.name: copy(getattr(obj, f.name)) for f in dataclasses.fields(cls)
          if f.name not in override}
    return cls(**kw, **override)


def general_mesh_from_jax(gm) -> GeneralMesh:
    """parelagmc_tpu.mesh.mfem_io.GeneralMesh -> port GeneralMesh."""
    return host_record_copy(gm, GeneralMesh)


def simplicial_level_from_jax(level):
    """A simplicial level (SimplicialLevel, with its mesh) or an
    agglomerated one (AgglomeratedLevel, no mesh) of the JAX package ->
    the port's class of the same name."""
    if hasattr(level, "mesh"):
        return host_record_copy(level, SimplicialLevel, mesh=general_mesh_from_jax(level.mesh))
    return host_record_copy(level, AgglomeratedLevel)


def simplicial_hierarchy_from_jax(h) -> SimplicialHierarchy:
    """parelagmc_tpu.fem.simplicial_hierarchy.SimplicialHierarchy (nested
    or agglomerated) -> port SimplicialHierarchy: levels, parent maps and
    RT prolongators."""
    return host_record_copy(h, SimplicialHierarchy,
                            levels=[simplicial_level_from_jax(l) for l in h.levels])


def hybrid_level_from_jax(H, dtype=torch.float64, device=None) -> HybridLevel:
    """parelagmc_tpu.physics.hybrid.HybridLevel -> port HybridLevel (the
    index tables as int64), so the two packages' tables can be compared
    field by field and a solve run on the same tables."""
    ints = ("c_idx", "lam_src", "own_src")
    kw = {}
    for name in HybridLevel._fields:
        v = getattr(H, name)
        if name in ("n_lam", "n_s", "nloc"):
            kw[name] = int(v)
        else:
            kw[name] = _t(v, torch.int64 if name in ints else dtype, device)
    return HybridLevel(**kw)
