"""Exact batched solves with the RT0 velocity mass matrix on tensor grids.

Port of parelagmc_tpu/ops/mass_solve.py (see its docstring). On an
axis-aligned tensor mesh M(w) is block-diagonal per axis and each axis
block splits into independent tridiagonal systems along grid lines, so
M(w)^{-1} is applied exactly per sample by batched Thomas solves.

Layout: everything stays in the port's natural grid layout. The static
tables are (z, y, x) cell grids and (z, y, x) face grids per axis; the
per-sample factor tables (dl, diag, du) are flat (B, n_u) face vectors,
laid out like the right-hand side (axis a is the block
face_offsets[a]:face_offsets[a+1] of each sample, a reversed face grid).

One solve per axis, two versions (the reference's scan / associative-scan /
tridiagonal_solve switches and its 32,768-cell crossover were TPU
measurements and are not ported):
* CUDA tensors: the K1 kernel (ops/tridiag_pallas.thomas_lines) reads the
  tables and r and writes z in that layout - one launch per axis straight
  into z's slice, no permute copy, no concatenation;
* CPU tensors: the plain composed path - slice each axis, permute its
  solved axis first, `thomas_plain`, permute back, concatenate.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from parelagmc_tpu_torch.fem.assembly import MixedLevel
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.ops.tridiag_pallas import grid_axis_layout, thomas_lines, thomas_plain


def build_line_tables(m_lo, m_mid, m_hi, ess, w, dim: int = 0):
    """(dl, diag, du) for the tridiagonal mass lines along `dim`: per-cell
    blocks (m_lo, m_mid, m_hi) scaled by the sample coefficient w (cells
    along `dim`; the face grid has one more row there), with essential rows
    replaced by identity and couplings into essential neighbours zeroed.
    The reference's build_line_tables, along any dim (it solves along the
    last)."""
    c_lo = w * m_lo
    c_mid = w * m_mid
    c_hi = w * m_hi
    zero = torch.zeros_like(c_lo.narrow(dim, 0, 1))
    diag = torch.cat([c_lo, zero], dim=dim) + torch.cat([zero, c_hi], dim=dim)
    du = torch.cat([c_mid, zero], dim=dim)  # couples (i, i+1)
    dl = torch.cat([zero, c_mid], dim=dim)  # couples (i, i-1)
    ess_next = torch.roll(ess, -1, dims=dim)
    ess_prev = torch.roll(ess, 1, dims=dim)
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    nil = torch.zeros((), dtype=diag.dtype, device=diag.device)
    diag = torch.where(ess, one, diag)
    du = torch.where(ess | ess_next, nil, du)
    dl = torch.where(ess | ess_prev, nil, dl)
    return dl, diag, du


class AxisTables(nn.Module):
    """Static per-axis data in the natural grid layout: per-cell
    coefficient tables on the (z, y, x) cell grid and the essential mask on
    the axis's (z, y, x) face grid; the axis is solved along array dim
    `dim` (mesh axis a is dim d - 1 - a)."""

    def __init__(self, m_lo, m_mid, m_hi, ess, n_a: int, dim: int):
        super().__init__()
        self.register_buffer("m_lo", m_lo)
        self.register_buffer("m_mid", m_mid)
        self.register_buffer("m_hi", m_hi)
        self.register_buffer("ess", ess)
        self.n_a = int(n_a)
        self.dim = int(dim)


class MassTridiagSolver(nn.Module):
    """z = M(w)^{-1} rhs by per-axis tridiagonal line solves."""

    def __init__(self, axes: List[AxisTables], shape: Tuple[int, ...],
                 face_offsets: Tuple[int, ...], n_u: int):
        super().__init__()
        self.axes = nn.ModuleList(axes)
        self.shape = tuple(int(s) for s in shape)
        self.face_offsets = tuple(int(x) for x in face_offsets)
        self.n_u = int(n_u)
        self.register_buffer("ess_flat", torch.cat([ax.ess.reshape(-1) for ax in axes]))
        self._layouts = {}

    def forward(self, w: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        return self.apply_factored(self.factor(w), rhs)

    def face_grid(self, a: int) -> Tuple[int, ...]:
        """Axis a's face grid in array (z, y, x) order."""
        fshape = list(self.shape)
        fshape[a] += 1
        return tuple(fshape[::-1])

    def factor(self, w: torch.Tensor):
        """(dl, diag, du), each a flat (B, n_u) face vector in the
        right-hand side's layout, for the sample coefficient w (..., n_s)
        flattened to B samples. Built once per Krylov solve and reused by
        apply_factored."""
        B = int(np.prod(w.shape[:-1])) if w.dim() > 1 else 1
        wg = w.reshape((B,) + self.shape[::-1])  # (B, z, y, x)
        parts = ([], [], [])
        for ax in self.axes:
            tables = build_line_tables(ax.m_lo, ax.m_mid, ax.m_hi, ax.ess.unsqueeze(0), wg,
                                       dim=1 + ax.dim)
            for out, t in zip(parts, tables):
                out.append(t.reshape(B, -1))
        return tuple(torch.cat(p, dim=-1) for p in parts)

    def masked_diag(self, factors, batch: Tuple[int, ...]) -> torch.Tensor:
        """diag M(w) as a flat (batch..., n_u) face vector with essential
        faces 0 (the reference's masked ELL diagonal L.m_diag(w)), read off
        the tables factor() built: their diagonal is the same per-cell sum
        with essential rows set to 1 instead."""
        return factors[1].masked_fill(self.ess_flat, 0.0).reshape(tuple(batch) + (self.n_u,))

    def layouts(self, B: int):
        """Per axis, the LineLayout of its lines in a flat (B, n_u) vector
        (kept per batch size: apply_factored runs once per CG iteration)."""
        if B not in self._layouts:
            self._layouts[B] = [grid_axis_layout(B, self.face_grid(a), ax.dim,
                                                 base=self.face_offsets[a], batch_stride=self.n_u)
                                for a, ax in enumerate(self.axes)]
        return self._layouts[B]

    def apply_factored(self, factors, rhs: torch.Tensor) -> torch.Tensor:
        """z = M^{-1} rhs for tables built by factor(): the K1 kernel for
        CUDA tensors, the plain composed path for CPU tensors. rhs is
        (batch..., n_u) with the tables' batch, or (batch..., R, n_u): R
        right-hand sides per sample (the stacked primal + adjoint solve),
        which the kernel solves reading each sample's tables once."""
        B = factors[1].shape[0]
        R, rem = divmod(rhs.numel(), B * self.n_u)
        if rem or R < 1:
            raise ValueError(f"apply_factored: rhs {tuple(rhs.shape)} against tables for "
                             f"{B} samples of {self.n_u} faces")
        r = rhs.reshape(B, R, self.n_u)
        if r.device.type == "cpu":
            z = self.apply_plain(factors, r)
        else:
            dl, diag, du = factors
            r = r.contiguous()
            z = torch.empty_like(r)
            for lay in self.layouts(B):
                thomas_lines(dl, diag, du, r, z, lay, rhs=R, rhs_stride=self.n_u,
                             rhs_batch_stride=R * self.n_u)
        return z.reshape(rhs.shape)

    def apply_plain(self, factors, r: torch.Tensor) -> torch.Tensor:
        """The plain composed M^{-1} on flat (B, n_u) or (B, R, n_u)
        vectors: per axis, slice, move the solved axis first (and the
        right-hand sides before it), thomas_plain, move them back, and
        concatenate the axes."""
        B = r.shape[0]
        many = r.dim() == 3
        outs = []
        for a, ax in enumerate(self.axes):
            lo, hi = self.face_offsets[a], self.face_offsets[a + 1]
            grid = (B,) + self.face_grid(a)
            first = lambda t: t[:, lo:hi].reshape(grid).movedim(1 + ax.dim, 0).contiguous()
            if many:
                R = r.shape[1]
                rg = r[:, :, lo:hi].reshape((B, R) + grid[1:])
                rhs = rg.movedim(2 + ax.dim, 0).movedim(2, 0).contiguous()  # (R, n_a, B, ...)
                z = thomas_plain(*(first(t) for t in factors), rhs)
                outs.append(z.movedim(0, 2).movedim(0, 2 + ax.dim).reshape(B, R, -1))
            else:
                z = thomas_plain(*(first(t) for t in (*factors, r)))
                outs.append(z.movedim(0, 1 + ax.dim).reshape(B, -1))
        return torch.cat(outs, dim=-1)


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
    entries differ, so m_hi comes from brr). `device` None means cuda:0."""
    device = resolve_device(device)
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
        fshape = list(shape)
        fshape[a] += 1
        ess_a = ess_mask[mesh.face_offsets[a]: mesh.face_offsets[a + 1]].reshape(
            tuple(fshape[::-1])
        )
        axes.append(
            AxisTables(
                m_lo=as_t(m_lo),
                m_mid=as_t(m_mid),
                m_hi=as_t(m_hi),
                ess=as_t(ess_a, torch.bool),
                n_a=shape[a],
                dim=d - 1 - a,  # mesh axis a is array dim d-1-a of the (z, y, x) grid
            )
        )
    return MassTridiagSolver(
        axes, shape, tuple(int(x) for x in mesh.face_offsets), lvl.n_u
    )
