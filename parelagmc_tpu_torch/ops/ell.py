"""Static-sparsity matrix-free operators in padded ELL form.

Port of parelagmc_tpu/ops/ell.py. A sparse operator with mesh-determined,
sample-independent sparsity is held as per-row index and value slabs of a
fixed width K, so applying it to a batch of vectors is a gather, a multiply
and a sum over K - plain PyTorch here, as in the reference (no kernel of
the reference covers it). Duplicate (row, col) slots accumulate and padded
slots carry value 0 at column 0.

The gathered tensor is batch x rows x K: callers with large meshes should
watch it (64^3 cells, K 8, batch 64 in float64 is 1.07 GB).

Two flavors, as in the reference: `ELL` holds fixed values; `CoefELL`
multiplies each slot by a per-sample piecewise-constant coefficient,
y = sum_k c[cells[r, k]] * mvals[r, k] * x[cols[r, k]] - the velocity mass
matrix M(w) of the saddle-system (minres-bj) solver, "re-assembled" per
sample by a gather. `DiagCoef` is the diagonal of such an operator; on
tensor meshes it equals MassTridiagSolver.masked_diag, which the Schur-CG
solvers read off their factor tables instead (held equal in the tests).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from parelagmc_tpu_torch.device import resolve_device


class ELL(nn.Module):
    """cols (n, K) int64 and vals (n, K) of y[r] = sum_k vals[r, k] *
    x[cols[r, k]] (the reference holds cols in int32; PyTorch indexes with
    int64)."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor):
        super().__init__()
        self.register_buffer("cols", cols)
        self.register_buffer("vals", vals)

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]


class CoefELL(nn.Module):
    """cols, cells (n, K) int64 and mvals (n, K) of a coefficient ELL."""

    def __init__(self, cols: torch.Tensor, mvals: torch.Tensor, cells: torch.Tensor):
        super().__init__()
        self.register_buffer("cols", cols)
        self.register_buffer("mvals", mvals)
        self.register_buffer("cells", cells)


class DiagCoef(nn.Module):
    """Diagonal of a CoefELL operator: diag(c)[r] = sum_k c[cells[r, k]] *
    vals[r, k]."""

    def __init__(self, cells: torch.Tensor, vals: torch.Tensor):
        super().__init__()
        self.register_buffer("cells", cells)
        self.register_buffer("vals", vals)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        cg = torch.index_select(c, -1, self.cells.reshape(-1))
        return torch.sum(cg.reshape(c.shape[:-1] + self.cells.shape) * self.vals, dim=-1)


def ell_apply(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """y[..., r] = sum_k vals[r, k] * x[..., cols[r, k]]."""
    gathered = torch.index_select(x, -1, ell.cols.reshape(-1))
    gathered = gathered.reshape(x.shape[:-1] + ell.cols.shape)
    return torch.sum(gathered * ell.vals, dim=-1)


def coef_ell_apply(op: CoefELL, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[..., r] = sum_k c[..., cells[r, k]] * mvals[r, k] * x[..., cols[r, k]],
    with c the per-sample piecewise-constant coefficient, batched like x."""
    xg = torch.index_select(x, -1, op.cols.reshape(-1)).reshape(x.shape[:-1] + op.cols.shape)
    cg = torch.index_select(c, -1, op.cells.reshape(-1)).reshape(c.shape[:-1] + op.cells.shape)
    return torch.sum(cg * op.mvals * xg, dim=-1)


def pack_csr_to_ell(csr, dtype: torch.dtype = torch.float32, width: Optional[int] = None,
                    device=None) -> ELL:
    """Pack a scipy CSR/COO matrix into a padded ELL on `device` (None:
    cuda:0)."""
    device = resolve_device(device)
    csr = csr.tocsr()
    n = csr.shape[0]
    counts = np.diff(csr.indptr)
    w = int(counts.max()) if n else 0
    if width is not None:
        if w > width:
            raise ValueError("requested ELL width too small")
        w = width
    cols = np.zeros((n, w), dtype=np.int64)
    vals = np.zeros((n, w), dtype=np.float64)
    for_rows = np.repeat(np.arange(n), counts)
    slots = np.arange(csr.indices.size) - np.repeat(csr.indptr[:-1], counts)
    cols[for_rows, slots] = csr.indices
    vals[for_rows, slots] = csr.data
    return ELL(torch.as_tensor(cols, device=device),
               torch.as_tensor(vals, dtype=dtype, device=device))


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a).astype(np.int64), device=device)


def pack_coef_ell(m_cols: np.ndarray, m_vals: np.ndarray, m_cells: np.ndarray,
                  dtype: torch.dtype = torch.float32, device=None) -> CoefELL:
    """A host-side coefficient ELL on `device` (None: cuda:0)."""
    device = resolve_device(device)
    return CoefELL(_idx(m_cols, device),
                   torch.as_tensor(np.ascontiguousarray(m_vals), dtype=dtype, device=device),
                   _idx(m_cells, device))


def coef_diag_structure(m_cols: np.ndarray, m_vals: np.ndarray, m_cells: np.ndarray,
                        dtype: torch.dtype = torch.float32, device=None) -> DiagCoef:
    """Extract the diagonal slots of a host-side coefficient ELL."""
    device = resolve_device(device)
    n, K = m_cols.shape
    rows = np.arange(n)[:, None]
    as_vals = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=device)
    # Fast path: build_mixed_level puts the (up to two) diagonal slots first.
    if (
        K >= 2
        and np.all((m_cols[:, :2] == rows) | (m_vals[:, :2] == 0.0))
        and np.all((m_cols[:, 2:] != rows) | (m_vals[:, 2:] == 0.0))
    ):
        vals01 = np.where(m_cols[:, :2] == rows, m_vals[:, :2], 0.0)
        return DiagCoef(_idx(m_cells[:, :2], device), as_vals(vals01))
    is_diag = (m_cols == rows) & (m_vals != 0.0)
    kd = int(is_diag.sum(axis=1).max()) if n else 0
    r_idx, j_idx = np.nonzero(is_diag)
    # Slot of each diagonal entry within its row (entries are row-sorted).
    starts = np.concatenate([[0], np.cumsum(is_diag.sum(axis=1))[:-1]])
    slot = np.arange(r_idx.size) - starts[r_idx]
    cells = np.zeros((n, kd), dtype=np.int64)
    vals = np.zeros((n, kd), dtype=np.float64)
    cells[r_idx, slot] = m_cells[r_idx, j_idx]
    vals[r_idx, slot] = m_vals[r_idx, j_idx]
    return DiagCoef(_idx(cells, device), as_vals(vals))
