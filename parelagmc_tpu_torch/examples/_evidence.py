"""What the evidence and tuning drivers share: host copies that wait for
the device, and device timing. The device line of their JSON files is
`parelagmc_tpu_torch.device.device_info`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from parelagmc_tpu_torch.device import synchronize


def host(x) -> np.ndarray:
    """A numpy copy of a tensor (the copy waits for the device), or of a
    host number."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def mean_of(values) -> float:
    """The float64 mean over per-call tensors or host numbers (every call's
    entries weighted alike)."""
    return float(np.mean([host(v).astype(np.float64) for v in values]))


def device_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of fn: CUDA events around `reps` back-to-back
    calls on a card, the host clock around them on the CPU."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
