"""What the evidence, tuning and probe drivers share: host copies that
wait for the device, device timing, the chain marginal of the probes and
their SPE10 problem. The device line of their JSON files and printouts is
`parelagmc_tpu_torch.device.device_info`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import synchronize
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv


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


def call_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2):
    """(events ms, wall ms) per call of fn over `reps` back-to-back calls:
    CUDA events around them on a card, and the host clock around the same
    calls up to a synchronize (on the CPU both are the host clock). Both
    include the device's idle gaps between launches (and behind a host
    sync inside fn); only a profiler's kernel time leaves them out."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall = (time.perf_counter() - t0) / reps * 1e3
        return wall, wall
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / reps * 1e3
    return start.elapsed_time(end) / reps, wall


def device_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of fn: CUDA events around `reps` back-to-back
    calls on a card, the host clock around them on the CPU."""
    return call_ms(fn, device, reps, warmup)[0]


def marginal(fn, x0, K: int, reps: int, device: torch.device) -> dict:
    """The chain marginal of fn: chains y <- fn(y) of 1 and of K calls from
    x0, each timed by call_ms over `reps` runs; (t_K - t_1) / (K - 1) is the
    cost of one more application, the chain's fixed cost taken out. Keys ms
    and wall_ms (the marginals), t1_ms, tK_ms, t1_wall_ms, tK_wall_ms."""

    def chain(k):
        def run():
            y = x0
            for _ in range(k):
                y = fn(y)
            return y

        return run

    (t1, w1), (tk, wk) = (call_ms(chain(k), device, reps, warmup=1) for k in (1, K))
    return dict(ms=(tk - t1) / (K - 1), wall_ms=(wk - w1) / (K - 1), t1_ms=t1, tK_ms=tk,
                t1_wall_ms=w1, tK_wall_ms=wk)


def marginal_line(label: str, r: dict, K: int, width: int) -> str:
    """A probe's printed line of one marginal: events, then the wall."""
    return (f"{label:{width}s} {r['ms']:8.3f} ms marginal   (t1 {r['t1_ms']:.2f} ms, "
            f"t{K} {r['tK_ms']:.2f} ms; wall {r['wall_ms']:.3f} ms marginal, t1 "
            f"{r['t1_wall_ms']:.2f} ms, t{K} {r['tK_wall_ms']:.2f} ms)")


def spe10_probe_config(batch: int, grid=SPE10_NCELLS, box: bool = False):
    """(config, kinv_ref) of the level-0 probes: the SPE10 problem at 2
    refinements, 100 ft correlation length, normalized marginals, on the
    synthetic permeability of `grid`, cg-schur-coefmg; with `box`, a box of
    `grid` cells with the SPE10 extents in place of the spe10 mesh."""
    cfg = ProblemConfig(mesh="spe10", refinements=2, batch_size=batch,
                        correlation_length=100.0, normalize_marginals=True)
    if box:
        lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
        f = 2 ** cfg.refinements
        cfg = dataclasses.replace(cfg, mesh="box", ncells=tuple(g // f for g in grid),
                                  lengths=lengths)
    cfg.darcy_solver.name = "cg-schur-coefmg"
    return cfg, load_spe10_kinv(None, ncells=grid)


def masked_dinv(L, w: torch.Tensor, fac=None) -> torch.Tensor:
    """The inverse of the masked diagonal of M(w) on a level (0 on
    essential faces): the coefMG's coefficient input, read off the mass
    tables (factored here unless `fac` is given)."""
    if fac is None:
        fac = L.mass_solver.factor(w)
    diag_w = L.mass_solver.masked_diag(fac, w.shape[:-1])
    pos = diag_w > 0
    return torch.where(pos, 1.0 / torch.where(pos, diag_w, torch.ones_like(diag_w)),
                       torch.zeros_like(diag_w))


def normal_tensor(rng: np.random.Generator, shape, dtype, device, scale=None) -> torch.Tensor:
    """rng.normal(size=shape) (exp(scale N) when `scale` is given) as a
    tensor of `dtype` on `device`."""
    x = rng.normal(size=shape)
    if scale is not None:
        x = np.exp(x * scale)
    return torch.as_tensor(x, dtype=dtype, device=device)
