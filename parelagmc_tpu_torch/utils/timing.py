"""Named-scope wall-clock timers (port of parelagmc_tpu/utils/timing.py).

Timer values feed back into the MLMC algorithm as the per-level cost model
(cost_model == "walltime"). CUDA execution is asynchronous, so a timer
that measures device work must synchronize before it stops: `timed` takes
an optional `block` (tensors, or a callable returning them) and
synchronizes every CUDA device they live on.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch


class _Watch:
    __slots__ = ("elapsed", "count", "last")

    def __init__(self) -> None:
        self.elapsed = 0.0
        self.count = 0
        self.last = 0.0


def block_until_ready(tree) -> None:
    """Wait for the CUDA work producing every tensor in `tree` (a tensor or
    a nested tuple/list/dict of them); CPU tensors need no wait."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class TimeManager:
    """Process-global registry of named accumulating timers."""

    _watches: Dict[str, _Watch] = OrderedDict()

    @classmethod
    def reset(cls) -> None:
        cls._watches = OrderedDict()

    @classmethod
    def get_watch(cls, name: str) -> _Watch:
        if name not in cls._watches:
            cls._watches[name] = _Watch()
        return cls._watches[name]

    @classmethod
    def elapsed(cls, name: str) -> float:
        """Total accumulated seconds for timer `name` (0.0 if never used)."""
        w = cls._watches.get(name)
        return w.elapsed if w is not None else 0.0

    @classmethod
    def last(cls, name: str) -> float:
        """Seconds of the most recent timed region for `name`."""
        w = cls._watches.get(name)
        return w.last if w is not None else 0.0

    @classmethod
    @contextmanager
    def timed(cls, name: str, block=None):
        """Accumulate wall time into timer `name`; if `block` is given (or
        a callable returning it), its CUDA work is synchronized before the
        timer stops."""
        w = cls.get_watch(name)
        t0 = time.perf_counter()
        try:
            yield w
        finally:
            if block is not None:
                block_until_ready(block() if callable(block) else block)
            w.last = time.perf_counter() - t0
            w.elapsed += w.last
            w.count += 1

    @classmethod
    def print_table(cls, stream=None) -> str:
        lines = ["%-60s %12s %8s" % ("Timer", "seconds", "calls")]
        lines.append("-" * 82)
        for name, w in cls._watches.items():
            lines.append("%-60s %12.6f %8d" % (name, w.elapsed, w.count))
        out = "\n".join(lines)
        if stream is not None:
            print(out, file=stream)
        return out


class SteadyCostLedger:
    """Per-level walltime ledger that keeps each level's FIRST timed batch
    in this process out of the cost model: the first batch pays one-time
    costs (CUDA context and module load, allocator growth) that would
    distort the optimal N_l allocation. When a level has run just one
    batch, the caller falls back to the all-inclusive timer."""

    def __init__(self, nlevels: int) -> None:
        self.time = np.zeros(nlevels)
        self.nsamples = np.zeros(nlevels, dtype=np.int64)
        self.first_time = np.zeros(nlevels)
        self.first_nsamples = np.zeros(nlevels, dtype=np.int64)
        self._seen_this_process: set = set()

    def seen(self, level: int) -> bool:
        return level in self._seen_this_process

    def add_batch(self, level: int, dt: float, nsamples: int) -> None:
        if level not in self._seen_this_process:
            self._seen_this_process.add(level)
            self.first_time[level] += float(dt)
            self.first_nsamples[level] += int(nsamples)
        else:
            self.time[level] += float(dt)
            self.nsamples[level] += int(nsamples)

    def cost_per_sample(self, level: int, fallback_time: float, fallback_n: int) -> float:
        """Steady-state seconds per sample; the all-inclusive timer when no
        steady batch exists yet."""
        if self.nsamples[level] > 0:
            return float(self.time[level]) / float(self.nsamples[level])
        return float(fallback_time) / max(int(fallback_n), 1)

    def state(self) -> dict:
        """The ledger as arrays for a checkpoint (np.savez keywords)."""
        return {
            "cost_ss_time": self.time,
            "cost_ss_n": self.nsamples,
            "cost_first_time": self.first_time,
            "cost_first_n": self.first_nsamples,
        }

    def load(self, data) -> None:
        """Restore from a checkpoint mapping; a checkpoint without the
        ledger keeps zeros (its cost falls back to the all-inclusive
        timer). The levels seen by this process are not restored: a resumed
        process pays its one-time costs again."""
        if "cost_ss_time" in getattr(data, "files", data):
            self.time = data["cost_ss_time"].copy()
            self.nsamples = data["cost_ss_n"].copy()
            self.first_time = data["cost_first_time"].copy()
            self.first_nsamples = data["cost_first_n"].copy()
