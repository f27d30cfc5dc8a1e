"""Device and dtype helpers.

The port's entry points run on the card: a `device` of None means
cuda:0 (under torchrun, cuda:LOCAL_RANK: one card a rank), and a CUDA
device that is not available raises - nothing falls back to the CPU. A
caller that wants the CPU (the tests) asks for it.
`device_info` is the line a JSON report names its device with: the card's
name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them, or "cpu".
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Union

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """ProblemConfig.dtype name (or a torch dtype) -> torch dtype. The
    solver path runs in float32 or float64; bfloat16 is not ported."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise NotImplementedError(f"dtype {dtype} is not supported by the port")
        return dtype
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"dtype {dtype!r} is not supported by the port (float32/float64)"
        )
    return _DTYPES[dtype]


def torchrun_local_rank() -> Optional[int]:
    """This process's LOCAL_RANK when torchrun's environment (WORLD_SIZE,
    RANK, LOCAL_RANK) is present, else None."""
    if all(k in os.environ for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK")):
        return int(os.environ["LOCAL_RANK"])
    return None


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """Normalize a device argument. None means cuda:0, and under torchrun
    cuda:LOCAL_RANK (so is a "cuda" without an index); a CUDA device that
    is not available raises instead of silently running elsewhere."""
    local = torchrun_local_rank()
    dev = torch.device(("cuda:0" if local is None else "cuda") if device is None else device)
    if dev.type == "cuda" and dev.index is None and local is not None:
        dev = torch.device("cuda", local)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def device_info(device: torch.device) -> str:
    """The card's "name, power limit" line from nvidia-smi, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
