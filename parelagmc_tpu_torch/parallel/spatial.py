"""Spatial domain decomposition of one SPD operator: the generic-CSR form.

Port of parelagmc_tpu/parallel/spatial.py, the prototype and oracle of the
spatial axis (the production form is parallel/spatial_darcy.SpatialDarcy):

* setup (host): renumber the dofs into contiguous, balanced 1D slabs
  (`slab_partition`); since a low-order FEM row couples only its own and
  the two neighbouring slabs, every slab gets an ELL whose columns index
  [own | halo from below | halo from above], plus static send lists;
* solve: the halo exchange is two one-slab shifts of padded boundary
  buffers, the SpMV a gather over the ELL (the port's ELL form,
  ops/ell.py), and the PCG sums its dots over the slabs.

It runs on the communicators of parallel/slabs.py (every slab in this
process, or one per torch.distributed rank) and holds no kernel. CPU tests:
tests/test_torch_spatial.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.parallel.slabs import slab_comm


class ShardedOperator(NamedTuple):
    """Static per-slab SpMV data, with a leading axis of the local slabs."""

    cols: torch.Tensor  # (n_local, n_loc, K) int64, columns into [own | halo_dn | halo_up]
    vals: torch.Tensor  # (n_local, n_loc, K)
    send_dn: torch.Tensor  # (n_local, H) local indices each slab sends down
    send_up: torch.Tensor  # (n_local, H)
    n_local: int
    n_halo: int  # H (max per direction, padded)
    perm: np.ndarray  # global renumbering: new[i] = old dof perm[i]


def build_sharded_operator(A: sp.spmatrix, slab: np.ndarray, n_sp: int,
                           dtype: torch.dtype = torch.float32, device=None,
                           slabs=None) -> ShardedOperator:
    """Partition symmetric CSR `A` by the per-row slab ids (0..n_sp-1,
    contiguous in space); keep the slabs `slabs` (default: all). Requires
    the 1D-decomposition property |slab[i] - slab[j]| <= 1 on every
    nonzero. `device` None means cuda:0."""
    device = resolve_device(device)
    A = A.tocsr()
    n = A.shape[0]
    slab = np.asarray(slab, dtype=np.int64)
    counts = np.bincount(slab, minlength=n_sp)
    if counts.min() <= 0:
        raise ValueError("every slab must own at least one dof")
    if counts.max() != counts.min():
        raise ValueError(f"slabs must be balanced for static shapes (got {counts})")
    n_loc = int(counts[0])
    perm = np.argsort(slab, kind="stable")  # new -> old
    B = A[perm][:, perm].tocsr()  # renumbered: slab s owns rows [s*n_loc, ...)
    coo = B.tocoo()
    s_r, s_c = coo.row // n_loc, coo.col // n_loc
    if np.abs(s_r - s_c).max() > 1:
        raise ValueError("operator couples non-adjacent slabs: not a 1D decomposition")
    need_dn = [np.unique(coo.col[(s_r == s) & (s_c == s - 1)]) for s in range(n_sp)]
    need_up = [np.unique(coo.col[(s_r == s) & (s_c == s + 1)]) for s in range(n_sp)]
    H = max([1] + [x.size for x in need_dn + need_up])
    send_dn = np.zeros((n_sp, H), dtype=np.int64)  # what s sends to s-1 (= s-1's need_up)
    send_up = np.zeros((n_sp, H), dtype=np.int64)  # what s sends to s+1
    for s in range(n_sp):
        if s + 1 < n_sp:
            idx = need_dn[s + 1] - s * n_loc
            send_up[s, : idx.size] = idx
        if s >= 1:
            idx = need_up[s - 1] - s * n_loc
            send_dn[s, : idx.size] = idx
    K = int(np.diff(B.indptr).max())
    cols = np.zeros((n_sp, n_loc, K), dtype=np.int64)
    vals = np.zeros((n_sp, n_loc, K), dtype=np.float64)
    for s in range(n_sp):
        lo, hi = s * n_loc, (s + 1) * n_loc
        sub = B[lo:hi]
        cmap = np.zeros(n, dtype=np.int64)
        cmap[lo:hi] = np.arange(n_loc)
        cmap[need_dn[s]] = n_loc + np.arange(need_dn[s].size)
        cmap[need_up[s]] = n_loc + H + np.arange(need_up[s].size)
        rr = np.repeat(np.arange(n_loc), np.diff(sub.indptr))
        slot = np.arange(sub.nnz) - np.repeat(sub.indptr[:-1], np.diff(sub.indptr))
        cols[s, rr, slot] = cmap[sub.indices]
        vals[s, rr, slot] = sub.data  # padding slots: column 0, value 0
    keep = list(range(n_sp)) if slabs is None else list(slabs)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a[keep]), dtype=dt, device=device)
    return ShardedOperator(cols=t(cols, torch.int64), vals=t(vals, dtype),
                           send_dn=t(send_dn, torch.int64), send_up=t(send_up, torch.int64),
                           n_local=n_loc, n_halo=H, perm=perm)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per slab, x[s, ..., idx[s, j]]: x (n_local, ..., n), idx (n_local, k)."""
    i = idx.reshape((idx.shape[0],) + (1,) * (x.dim() - 2) + (idx.shape[-1],))
    return torch.gather(x, -1, i.expand(x.shape[:-1] + idx.shape[-1:]))


def _halo_exchange(op: ShardedOperator, x: torch.Tensor, comm) -> torch.Tensor:
    """[x | halo_dn | halo_up] for each local slab, x (n_local, ..., n_loc):
    halo_dn is what the slab below sent up, halo_up what the slab above
    sent down."""
    halo_dn = comm.halo_up(_take(x, op.send_up))
    halo_up = comm.halo_dn(_take(x, op.send_dn))
    return torch.cat([x, halo_dn, halo_up], dim=-1)


def spmv_sharded(op: ShardedOperator, x: torch.Tensor, comm) -> torch.Tensor:
    """y = A x on the local slabs (n_local, ..., n_loc)."""
    xh = _halo_exchange(op, x, comm)
    K = op.cols.shape[-1]
    g = _take(xh, op.cols.reshape(op.cols.shape[0], -1))
    vals = op.vals.reshape((op.vals.shape[0],) + (1,) * (x.dim() - 2) + op.vals.shape[1:])
    return torch.sum(g.unflatten(-1, (op.n_local, K)) * vals, dim=-1)


def pcg_sharded(apply_A: Callable, b: torch.Tensor, comm, prec: Optional[Callable] = None,
                max_iters: int = 300, rtol: float = 1e-6, atol: float = 1e-30):
    """Batched PCG on slab-sharded vectors (n_local, ..., n_loc): the dots
    summed over the slabs, the loop flag reduced over every rank.
    Returns (x, iterations)."""
    if prec is None:
        prec = lambda r: r
    vdot = lambda u, v: comm.psum(torch.sum(u * v, dim=-1))
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = vdot(r, z)
    thresh = torch.clamp(rtol * torch.sqrt(vdot(b, b)), min=atol)
    rn = torch.sqrt(vdot(r, r))
    it = 0
    while it < max_iters and comm.any_all(rn > thresh):
        Ap = apply_A(p)
        pAp = vdot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, one, pAp), zero)
        active = rn > thresh
        alpha = torch.where(active, alpha, zero)[..., None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = vdot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, one, rz), zero)
        p = z + torch.where(active, beta, zero)[..., None] * p
        rz = rz_new
        rn = torch.sqrt(vdot(r, r))
        it += 1
    return x, it


class SpatialSolver:
    """Spatially sharded batched PCG for one SPD operator: the solution,
    residuals and SpMV halos live in n_sp slabs; only halo planes and
    per-row scalars cross slabs. It runs distributed when a process group
    of n_sp ranks is up, else stacked; `device` None means cuda:0."""

    def __init__(self, A: sp.spmatrix, points: np.ndarray, n_sp: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        """`points`: (n, d) dof locations driving the slab partition."""
        self.device = resolve_device(device)
        self.comm = slab_comm(n_sp)
        self.n_sp = self.comm.n_sp
        A = A.tocsr()
        self.n = A.shape[0]
        # Pad with decoupled identity dofs to a multiple of the slab count
        # (equal slabs; the padded dofs sort into the last slab).
        pad = (-self.n) % self.n_sp
        if pad:
            A = sp.block_diag([A, sp.eye(pad)]).tocsr()
            points = np.vstack([points, np.full((pad, points.shape[1]), np.inf)])
        slab = slab_partition(points, self.n_sp)
        self.op = build_sharded_operator(A, slab, self.n_sp, dtype, self.device,
                                         slabs=self.comm.slabs)
        d = np.asarray(A.diagonal())[self.op.perm].reshape(self.n_sp, -1)[self.comm.slabs]
        self._dinv = torch.as_tensor(1.0 / np.where(d == 0, 1.0, d), dtype=dtype,
                                     device=self.device)

    def solve(self, b: np.ndarray, max_iters: int = 300, rtol: float = 1e-6):
        """Solve A x = b for (..., n) right-hand sides in the original dof
        order. Returns (x as numpy, iterations)."""
        op, comm = self.op, self.comm
        b = np.asarray(b, dtype=np.float64)
        pad = op.perm.size - self.n
        if pad:
            b = np.concatenate([b, np.zeros(b.shape[:-1] + (pad,))], axis=-1)
        bs = b[..., op.perm].reshape(b.shape[:-1] + (self.n_sp, op.n_local))
        bs = np.moveaxis(bs, -2, 0)[comm.slabs]  # (n_local, ..., n_loc)
        bt = torch.as_tensor(np.ascontiguousarray(bs), dtype=self._dinv.dtype,
                             device=self.device)
        dinv = self._dinv.reshape((self._dinv.shape[0],) + (1,) * (bt.dim() - 2)
                                  + (op.n_local,))
        x, it = pcg_sharded(lambda v: spmv_sharded(op, v, comm), bt, comm,
                            prec=lambda r: r * dinv, max_iters=max_iters, rtol=rtol)
        xs = comm.gather_slabs(x.unsqueeze(1) if x.dim() == 2 else x)
        # (row groups, n_sp, ..., n_loc) -> (..., n) in the renumbered order
        xs = xs[0].movedim(0, -2).flatten(-2).cpu().numpy()
        if x.dim() == 2:
            xs = xs[0]
        inv = np.empty_like(op.perm)
        inv[op.perm] = np.arange(op.perm.size)
        return xs[..., inv][..., : self.n], it


def slab_partition(points: np.ndarray, n_sp: int, axis_dim: Optional[int] = None):
    """Balanced contiguous 1D slabs by coordinate quantile along the longest
    (or the given) axis. Returns per-point slab ids with exactly n / n_sp
    points each (n divisible)."""
    points = np.asarray(points)
    if axis_dim is None:
        spans = points.max(axis=0) - points.min(axis=0)
        axis_dim = int(np.argmax(spans))
    n = points.shape[0]
    if n % n_sp:
        raise ValueError(f"{n} dofs not divisible into {n_sp} equal slabs")
    order = np.argsort(points[:, axis_dim], kind="stable")
    slab = np.empty(n, dtype=np.int64)
    slab[order] = np.arange(n) // (n // n_sp)
    return slab
