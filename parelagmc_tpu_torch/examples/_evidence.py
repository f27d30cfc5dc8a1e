"""What the evidence and tuning drivers share: the device line of their
JSON files, host copies that wait for the device, and device timing.

A driver's JSON names the device it ran on under the key "device": the
card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them, or "cpu".
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


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


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
