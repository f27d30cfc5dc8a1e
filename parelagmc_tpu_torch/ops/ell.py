"""Static-sparsity matrix-free operators in padded ELL form.

Port of `ELL`, `ell_apply` and `pack_csr_to_ell` from
parelagmc_tpu/ops/ell.py. A sparse operator with mesh-determined,
sample-independent sparsity is held as per-row index and value slabs of a
fixed width K, so applying it to a batch of vectors is a gather, a multiply
and a sum over K - plain PyTorch here, as in the reference (no kernel of
the reference covers it). Duplicate (row, col) slots accumulate and padded
slots carry value 0 at column 0.

The gathered tensor is batch x rows x K: callers with large meshes should
watch it (64^3 cells, K 8, batch 64 in float64 is 1.07 GB).

`CoefELL`, `DiagCoef` and their packers (the per-sample coefficient mass
matrix of the unstructured solvers) are not ported yet: ROADMAP.md Queue 1,
item 13, is their first caller.
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


def ell_apply(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """y[..., r] = sum_k vals[r, k] * x[..., cols[r, k]]."""
    gathered = torch.index_select(x, -1, ell.cols.reshape(-1))
    gathered = gathered.reshape(x.shape[:-1] + ell.cols.shape)
    return torch.sum(gathered * ell.vals, dim=-1)


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
