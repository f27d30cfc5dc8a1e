"""The collectives of a spatially sharded solve, run two ways.

The slab arithmetic of parallel/spatial_darcy.py and parallel/spatial.py is
written once against this small object. Every slab-local tensor carries a
leading slab axis of `n_local` entries, the slabs this process holds:

* `StackedSlabs(n_sp, n_dp)`: every slab in one process (n_local = n_sp),
  the default. A halo is a shift along the slab axis with a zero plane at
  the end, `all_gather` is the tensor itself, `psum` a sum over the axis.
  One launch serves every slab, and any n_sp >= 1 runs on one device. This
  form does NOT lower the memory of a device: all slabs live on it.
* `DistributedSlabs(n_sp, n_dp)`: one slab per torch.distributed rank
  (n_local = 1), world size n_sp * n_dp, rank r holding slab r % n_sp of
  dp row r // n_sp (the JAX package's (dp, sp) device mesh, row-major).
  Halos go by isend/irecv to the neighbouring ranks of the row, `all_gather`
  and `psum` over the row's process group, and the loop flags are reduced
  over the whole world, so every rank leaves a Krylov loop on the same
  iteration. The caller initializes the process group: gloo for CPU
  tensors, NCCL for CUDA ones with one card a rank. This is the form that
  lowers a device's share of the solve state (Krylov vectors, line tables,
  preconditioner state) to about 1/n_sp; every rank still holds the whole
  batch of coefficient fields and its solver's unsharded operators.

In the stacked form the sample batch is not split over dp rows: every
sample's arithmetic is independent of the others (per-sample dots, a loop
count and restarts shared by the whole batch, as under the JAX package's
(dp, sp) mesh), so both forms give the same per-sample values.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def distributed_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


class StackedSlabs:
    """All n_sp slabs on the leading axis of every tensor, in one process."""

    distributed = False

    def __init__(self, n_sp: int, n_dp: int = 1):
        self.n_sp, self.n_dp = int(n_sp), int(n_dp)
        if self.n_sp < 1 or self.n_dp < 1:
            raise ValueError(f"need n_sp, n_dp >= 1, got {n_sp}, {n_dp}")
        self.n_local = self.n_sp
        self.slabs = list(range(self.n_sp))  # global indices of the local slabs

    def halo_up(self, x: torch.Tensor) -> torch.Tensor:
        """Slab s receives slab s-1's `x`; slab 0 receives zeros."""
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]])

    def halo_dn(self, x: torch.Tensor) -> torch.Tensor:
        """Slab s receives slab s+1's `x`; the last slab receives zeros."""
        return torch.cat([x[1:], torch.zeros_like(x[:1])])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n_sp, ...): every slab's `x`, in slab order."""
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the slabs, keeping a slab axis of one."""
        return x.sum(0, keepdim=True)

    def any_all(self, flag: torch.Tensor) -> bool:
        """Whether `flag` holds anywhere, on any rank (one host sync)."""
        return bool(flag.any())

    def local_rows(self, B: int) -> slice:
        """The batch rows of this process."""
        return slice(0, B)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Per-sample results of the local rows -> the whole batch."""
        return x

    def gather_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """(n_dp_rows, n_sp, rows, ...) from the local (n_local, rows, ...)."""
        return x.unsqueeze(0)


class DistributedSlabs(StackedSlabs):
    """One slab per torch.distributed rank (see the module docstring)."""

    distributed = True

    def __init__(self, n_sp: int, n_dp: int = 1):
        super().__init__(n_sp, n_dp)
        if not distributed_ready():
            raise ValueError("DistributedSlabs needs an initialized torch.distributed "
                             "process group")
        world = dist.get_world_size()
        if world != self.n_sp * self.n_dp:
            raise ValueError(f"spatial sharding over n_dp * n_sp = {self.n_dp} * {self.n_sp} "
                             f"ranks, world size {world}")
        self.rank = dist.get_rank()
        self.dp_row, sp = divmod(self.rank, self.n_sp)
        self.n_local = 1
        self.slabs = [sp]
        # Every rank creates every row's group, in the same order.
        rows = [[r * self.n_sp + j for j in range(self.n_sp)] for r in range(self.n_dp)]
        groups = [dist.new_group(ranks) for ranks in rows]
        self.row_ranks = rows[self.dp_row]
        self.group = groups[self.dp_row]

    def _shift(self, x: torch.Tensor, to: int) -> torch.Tensor:
        """Send x to slab s + to, receive from slab s - to (zeros at the end)."""
        s = self.slabs[0]
        x = x.contiguous()
        out = torch.zeros_like(x)
        reqs = []
        if 0 <= s + to < self.n_sp:
            reqs.append(dist.isend(x, self.row_ranks[s + to]))
        if 0 <= s - to < self.n_sp:
            reqs.append(dist.irecv(out, self.row_ranks[s - to]))
        for r in reqs:
            r.wait()
        return out

    def halo_up(self, x: torch.Tensor) -> torch.Tensor:
        return self._shift(x, 1)

    def halo_dn(self, x: torch.Tensor) -> torch.Tensor:
        return self._shift(x, -1)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.n_sp)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.sum(0, keepdim=True).contiguous()
        dist.all_reduce(out, group=self.group)
        return out

    def any_all(self, flag: torch.Tensor) -> bool:
        n = flag.sum().to(torch.int64).reshape(1)
        dist.all_reduce(n)
        return bool(n.item() > 0)

    def local_rows(self, B: int) -> slice:
        rows = B // self.n_dp
        return slice(self.dp_row * rows, (self.dp_row + 1) * rows)

    def _gather_world(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bool:  # not every backend reduces or gathers bool
            return self._gather_world(x.to(torch.uint8)).bool()
        parts = [torch.empty_like(x) for _ in range(self.n_dp * self.n_sp)]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts).unflatten(0, (self.n_dp, self.n_sp))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        # Equal within a dp row (psum): take slab 0's copy of each row.
        return self._gather_world(x)[:, 0].flatten(0, 1)

    def gather_slabs(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather_world(x[0])


def slab_comm(n_sp: int, n_dp: int = 1) -> StackedSlabs:
    """The communicator of an n_sp x n_dp spatial sharding: distributed when
    a process group is up whose world size is n_sp * n_dp, else stacked in
    this process."""
    if distributed_ready() and dist.get_world_size() == int(n_sp) * int(n_dp):
        return DistributedSlabs(n_sp, n_dp)
    return StackedSlabs(n_sp, n_dp)
