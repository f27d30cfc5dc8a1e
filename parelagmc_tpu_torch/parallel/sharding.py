"""Sample sharding: the estimator batch split into shards.

Port of parelagmc_tpu/parallel/sharding.py. A per-shard level step (key ->
tuple of (local_batch, ...) tensors) becomes a global step (key -> tuple of
(global_batch, ...) tensors): shard i draws with fold_in(key, i), runs the
local batch batch // n, and the shards' outputs are concatenated along the
batch in shard order. The sample stream depends on the shard count alone,
not on the hardware, so one implementation runs in two ways:

* in one process, `SampleMesh(n)` runs the n shards one after the other
  on the manager's device (any n >= 1: the shards need not be devices);
* under torch.distributed (`SampleMesh(n, distributed=True)`, n the world
  size), each rank runs its own shard on its own device and the per-shard
  outputs are gathered with all_gather, so every rank holds the global
  batch. The process group comes from torchrun through
  parallel/launch.init_from_env (the drivers' parse_args calls it): gloo
  for CPU tensors, NCCL for CUDA ones with one card a rank; each rank builds
  its problem on its own device.

Both give the same per-sample values for the same n.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from parelagmc_tpu_torch.ops.prng import fold_in
from parelagmc_tpu_torch.parallel.launch import distributed_ready


def sample_mesh_from_config(config, device=None) -> Optional["SampleMesh"]:
    """The SampleMesh `config.sample_shards` asks for, or None: 0 or 1 is
    off, -1 is every visible device, < -1 and more than visible raise
    ValueError. Visible devices are the world size under torch.distributed,
    else torch.cuda.device_count() for a CUDA `device` and 1 for the CPU,
    so -1 on one device runs one shard keyed fold_in(key, 0), as the
    reference's one-device mesh does."""
    n = config.sample_shards
    if n in (0, 1):
        return None
    if n < -1:
        raise ValueError(f"config.sample_shards={n} is invalid (use -1 for all devices)")
    if distributed_ready():
        visible = dist.get_world_size()
    elif device is not None and torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
    else:
        visible = 1
    if n == -1:
        n = visible
    if n > visible:
        raise ValueError(
            f"config.sample_shards={n} but only {visible} device(s) are visible")
    return SampleMesh(n, distributed=distributed_ready())


class SampleMesh:
    """n sample shards, run in one process or one per torch.distributed
    rank (see the module docstring)."""

    def __init__(self, n_shards: int, distributed: bool = False):
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"SampleMesh needs at least one shard, got {n_shards}")
        self.distributed = bool(distributed)
        self.rank = 0
        if self.distributed:
            if not distributed_ready():
                raise ValueError("SampleMesh(distributed=True) needs an initialized "
                                 "torch.distributed process group")
            if n_shards != dist.get_world_size():
                raise ValueError(f"under torch.distributed the shards are the ranks: "
                                 f"{n_shards} shards, world size {dist.get_world_size()}")
            self.rank = dist.get_rank()
        self._n = n_shards

    @property
    def n_devices(self) -> int:
        return self._n

    def round_batch(self, batch: int) -> int:
        """Smallest multiple of the shard count >= batch."""
        n = self._n
        return -(-batch // n) * n

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self._n)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def _run(self, local: Callable, args_of_shard: Callable):
        if self.distributed:
            return tuple(self._gather(x) for x in local(*args_of_shard(self.rank)))
        outs = [local(*args_of_shard(i)) for i in range(self._n)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def shard_step(self, step_local: Callable) -> Callable:
        """Lift a per-shard step `key -> tuple of (local_batch, ...)
        tensors` to `key -> tuple of (global_batch, ...) tensors`; shard i
        draws with fold_in(key, i)."""
        return lambda key: self._run(step_local, lambda i: (fold_in(key, i),))

    def shard_stage(self, stage_local: Callable) -> Callable:
        """Lift a continuation stage over batch-led arrays (tuple of
        (local_batch, ...) -> tuple of (local_batch, ...)) to global
        arrays: shard i runs on the i-th of n equal chunks of each input.
        There is no key to fold."""
        def stage(*arrays):
            return self._run(stage_local,
                             lambda i: tuple(a.chunk(self._n)[i] for a in arrays))

        return stage
