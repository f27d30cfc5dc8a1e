"""Converters from the JAX package's operator objects to the port's.

Duck-typed: they read the JAX objects' fields and call np.asarray on their
arrays, so this module imports no jax. The tests use them to hold the
port's own build functions against the reference's arrays, and to run both
packages on identical operators. `device` None means cuda:0, as at every
entry point of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.ops.coef_multigrid_structured import StructCoefMG, StructMGLevel
from parelagmc_tpu_torch.ops.mass_solve import AxisTables, MassTridiagSolver
from parelagmc_tpu_torch.ops.tensorsolve import TensorEig
from parelagmc_tpu_torch.physics.darcy import DarcyLevel


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
    """parelagmc_tpu.physics.darcy.DarcyLevel (tensor mesh, cg-schur data,
    structured coefMG if any) -> port DarcyLevel. The reference's
    kinv_logmean / kinv_cell are not carried: they feed only the kinv_ref
    scalings of the S(1) preconditioner, which the port does not run."""
    if L.b_struct is None:
        raise ValueError("only tensor-mesh levels (b_struct set) convert")
    if L.coef_mg is not None and not hasattr(L.coef_mg, "face_offsets"):
        raise ValueError("only the structured coefMG converts")
    shape, offs, masks = L.b_struct
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
        coef_mg=struct_coef_mg_from_jax(L.coef_mg) if L.coef_mg is not None else None,
    )
