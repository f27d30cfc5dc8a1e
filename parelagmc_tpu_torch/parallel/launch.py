"""Launch under torchrun: one process a card, one torch.distributed group.

The counterpart of the JAX package's device discovery (`jax.devices()` in
parelagmc_tpu/parallel/sharding.py and parallel/spatial.py): there one
process sees every device of the host; here torchrun starts one process a
card and `init_from_env` joins them into a process group, which the
distributed forms (`SampleMesh(n, distributed=True)`, `DistributedSlabs`)
then run over:

    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        -m parelagmc_tpu_torch.examples.mlmc --sample-shards -1

On the cards the group is NCCL with rank r bound to cuda:LOCAL_RANK; with
`--device cpu` it is gloo. Nothing falls back: a NCCL init that fails
raises, gloo never carries CUDA tensors, and a CUDA device under torchrun
without a card raises. Without torchrun's environment (WORLD_SIZE, RANK,
LOCAL_RANK) nothing is initialized and the device is resolve_device's.

Every rank of a group runs the same program on the same global batch, so
the estimator decisions that read a rank's own clock are agreed over the
group (`agree_max`), and output is written by rank 0 alone (`is_main`).
"""

from __future__ import annotations

import atexit

import numpy as np
import torch
import torch.distributed as dist

from parelagmc_tpu_torch.device import resolve_device, torchrun_local_rank


def distributed_ready() -> bool:
    """Whether a torch.distributed process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if distributed_ready() else 1


def is_main() -> bool:
    """Rank 0 of the process group, or any process without one."""
    return not distributed_ready() or dist.get_rank() == 0


def _destroy() -> None:
    if distributed_ready():
        dist.destroy_process_group()


def init_from_env(device=None) -> torch.device:
    """The device of this process. Under torchrun (its environment is
    present) this also binds the rank to its card - `device`, or
    cuda:LOCAL_RANK - with torch.cuda.set_device, initializes the process
    group (NCCL for a CUDA device, gloo for the CPU; once per process) and
    registers its destruction at exit. Otherwise it is resolve_device."""
    dev = resolve_device(device)
    if torchrun_local_rank() is None or distributed_ready():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    atexit.register(_destroy)
    return dev


def agree_max(values: np.ndarray) -> np.ndarray:
    """The elementwise maximum of `values` over the ranks of a group of
    world size > 1 (every rank must call it), else `values` unchanged."""
    if world_size() == 1:
        return values
    # NCCL takes the tensors of a collective on this rank's card, gloo on the CPU.
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(np.asarray(values, dtype=np.float64), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy()


def barrier() -> None:
    """Wait for every rank of a group of world size > 1."""
    if world_size() > 1:
        dist.barrier()
