"""Exact batched solves with the RT0 velocity mass matrix on tensor grids.

Port of parelagmc_tpu/ops/mass_solve.py (see its docstring). On an
axis-aligned tensor mesh M(w) is block-diagonal per axis and each axis
block splits into independent tridiagonal systems along grid lines, so
M(w)^{-1} is applied exactly per sample by batched Thomas solves.

One solve path: `ops.tridiag_pallas.thomas`, which is the K1 CUDA kernel
for CUDA tensors and its plain version on the CPU, at every size. (The
reference's scan / associative-scan / tridiagonal_solve switches and its
32,768-cell crossover were TPU measurements and are not ported.)

Layout: per axis the static tables and the per-sample factor tables are
held with the SOLVED axis first - (n_a, lines...) for the static tables,
(n_a + 1, batch, lines...) for the factors - which is the (n, L) layout the
kernel reads coalesced. The reference keeps the solved axis last; the
converters in parelagmc_tpu_torch/convert.py move it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from parelagmc_tpu.fem.assembly import MixedLevel
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas


def build_line_tables(m_lo, m_mid, m_hi, ess, w):
    """(dl, diag, du) for the tridiagonal mass lines along dim 0: per-cell
    blocks (m_lo, m_mid, m_hi) scaled by the sample coefficient w (cells
    along dim 0; the face grid has one more row), with essential rows
    replaced by identity and couplings into essential neighbours zeroed.
    The reference's build_line_tables with the solved axis first."""
    c_lo = w * m_lo
    c_mid = w * m_mid
    c_hi = w * m_hi
    zero = torch.zeros_like(c_lo[:1])
    diag = torch.cat([c_lo, zero], dim=0) + torch.cat([zero, c_hi], dim=0)
    du = torch.cat([c_mid, zero], dim=0)  # couples (i, i+1)
    dl = torch.cat([zero, c_mid], dim=0)  # couples (i, i-1)
    ess_next = torch.cat([ess[1:], ess[:1]], dim=0)
    ess_prev = torch.cat([ess[-1:], ess[:-1]], dim=0)
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    nil = torch.zeros((), dtype=diag.dtype, device=diag.device)
    diag = torch.where(ess, one, diag)
    du = torch.where(ess | ess_next, nil, du)
    dl = torch.where(ess | ess_prev, nil, dl)
    return dl, diag, du


class AxisTables(nn.Module):
    """Static per-axis data: per-cell coefficient tables (n_a, lines...)
    and the face essential mask (n_a + 1, lines...), solved axis first.
    `perm` maps the (z, y, x) reversed grid to (axis, other dims...);
    `batch_perm` does the same for a batched (B, z, y, x) grid, putting the
    batch right after the solved axis: (axis, B, other dims...)."""

    def __init__(self, m_lo, m_mid, m_hi, ess, n_a: int, perm: Tuple[int, ...]):
        super().__init__()
        self.register_buffer("m_lo", m_lo)
        self.register_buffer("m_mid", m_mid)
        self.register_buffer("m_hi", m_hi)
        self.register_buffer("ess", ess)
        self.n_a = int(n_a)
        self.perm = tuple(int(p) for p in perm)
        self.batch_perm = (1 + self.perm[0], 0) + tuple(1 + p for p in self.perm[1:])


class MassTridiagSolver(nn.Module):
    """z = M(w)^{-1} rhs by per-axis tridiagonal line solves."""

    def __init__(self, axes: List[AxisTables], shape: Tuple[int, ...],
                 face_offsets: Tuple[int, ...], n_u: int):
        super().__init__()
        self.axes = nn.ModuleList(axes)
        self.shape = tuple(int(s) for s in shape)
        self.face_offsets = tuple(int(x) for x in face_offsets)
        self.n_u = int(n_u)

    def forward(self, w: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        return self.apply_factored(self.factor(w), rhs)

    def factor(self, w: torch.Tensor):
        """Per-axis (dl, diag, du), each (n_a + 1, B, lines...) contiguous,
        for the sample coefficient w (..., n_s) flattened to B samples.
        Built once per Krylov solve and reused by apply_factored."""
        B = int(np.prod(w.shape[:-1])) if w.dim() > 1 else 1
        wg = w.reshape((B,) + self.shape[::-1])  # (B, z, y, x)
        factors = []
        for ax in self.axes:
            w_a = wg.permute(ax.batch_perm)
            tables = build_line_tables(
                ax.m_lo.unsqueeze(1), ax.m_mid.unsqueeze(1),
                ax.m_hi.unsqueeze(1), ax.ess.unsqueeze(1), w_a,
            )
            factors.append(tuple(t.contiguous() for t in tables))
        return tuple(factors)

    def masked_diag(self, factors, batch: Tuple[int, ...]) -> torch.Tensor:
        """diag M(w) as a flat (batch..., n_u) face vector with essential
        faces 0 (the reference's masked ELL diagonal L.m_diag(w)), read off
        the tables factor() built: their diagonal is the same per-cell sum
        with essential rows set to 1 instead."""
        B = int(np.prod(batch)) if batch else 1
        outs = []
        for a, ax in enumerate(self.axes):
            diag = factors[a][1].masked_fill(ax.ess.unsqueeze(1), 0.0)
            inv = tuple(int(i) for i in np.argsort(ax.batch_perm))
            outs.append(diag.permute(inv).reshape(B, -1))
        return torch.cat(outs, dim=-1).reshape(tuple(batch) + (self.n_u,))

    def apply_factored(self, factors, rhs: torch.Tensor) -> torch.Tensor:
        """z = M^{-1} rhs for tables built by factor() (same batch)."""
        batch = rhs.shape[:-1]
        B = int(np.prod(batch)) if batch else 1
        outs = []
        for a, ax in enumerate(self.axes):
            dl, diag, du = factors[a]
            fshape = list(self.shape)
            fshape[a] += 1
            r = rhs[..., self.face_offsets[a]: self.face_offsets[a + 1]]
            r = r.reshape((B,) + tuple(fshape[::-1]))
            z = thomas(dl, diag, du, r.permute(ax.batch_perm).contiguous())
            inv = tuple(int(i) for i in np.argsort(ax.batch_perm))
            outs.append(z.permute(inv).reshape(B, -1))
        return torch.cat(outs, dim=-1).reshape(batch + (self.n_u,))


def build_mass_tridiag_solver(
    lvl: MixedLevel,
    ess_mask: np.ndarray,
    kinv_ref: Optional[np.ndarray] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    axis_blocks=None,
) -> MassTridiagSolver:
    """Static factors for M(w)^{-1} on `lvl`'s mesh with essential dofs
    `ess_mask`: the rediscretized RT0 mass with an optional static per-axis
    inverse permeability kinv_ref ((n_s, d) or (n_s,)) folded in, or the
    general per-cell Galerkin blocks (bll, blr, brr) of
    fem/galerkin_mass.py via `axis_blocks` (their lo and hi diagonal
    entries differ, so m_hi comes from brr)."""
    mesh = lvl.mesh
    d = mesh.dim
    shape = mesh.shape
    vol = mesh.cell_volumes().reshape(shape[::-1])  # (z, y, x)
    as_t = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                               device=device)
    axes = []
    for a in range(d):
        if axis_blocks is not None:
            bll, blr, brr = axis_blocks
            m_lo = bll[:, a].reshape(shape[::-1])
            m_mid = blr[:, a].reshape(shape[::-1])
            m_hi = brr[:, a].reshape(shape[::-1])
        else:
            h = mesh.cell_widths(a).reshape(shape[::-1])
            m_lo = h * h / (3.0 * vol)
            m_mid = 0.5 * m_lo
            if kinv_ref is not None:
                k = np.asarray(kinv_ref)
                ka = (k[:, a] if k.ndim == 2 else k).reshape(shape[::-1])
                m_lo = m_lo * ka
                m_mid = m_mid * ka
            m_hi = m_lo
        # Mesh axis a is array dim d-1-a of the (z, y, x) grid; move it first.
        dim_a = d - 1 - a
        perm = (dim_a,) + tuple(i for i in range(d) if i != dim_a)
        fshape = list(shape)
        fshape[a] += 1
        ess_a = ess_mask[mesh.face_offsets[a]: mesh.face_offsets[a + 1]].reshape(
            tuple(fshape[::-1])
        )
        axes.append(
            AxisTables(
                m_lo=as_t(np.transpose(m_lo, perm)),
                m_mid=as_t(np.transpose(m_mid, perm)),
                m_hi=as_t(np.transpose(m_hi, perm)),
                ess=as_t(np.transpose(ess_a, perm), torch.bool),
                n_a=shape[a],
                perm=perm,
            )
        )
    return MassTridiagSolver(
        axes, shape, tuple(int(x) for x in mesh.face_offsets), lvl.n_u
    )
