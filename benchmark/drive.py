"""The one general generator: builds a configuration's problem through the
port's own entry points and drives the managers as a traffic mix asks.

A traffic file (benchmark/traffic/<mix>.json) gives `kind` and its
parameters:

* "level_steps" (`level`, `batch`): back-to-back batches of one MLMC level
  step through `MLMCManager.init_run`, the manager keyed from the run's
  seed; one unit is one batch.

Every mix is a closed loop: the next unit starts when the last has
returned. The window runs units until `seconds` have passed and ends with
the last unit begun before then.

`Recorder` wraps the sampler's and the solver's methods on the objects the
manager is handed (instance attributes, no file of the port changes): it
keeps each batch's key, Q values and solver info for the check, and in a
traced run a synchronized span around each call (also a profiler range
named `bench.<span>`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def problem_config(spec: dict, seed: int = 0, **overrides):
    """ProblemConfig of a configuration file's `problem` entries."""
    from parelagmc_tpu_torch.config import ProblemConfig, SolverConfig

    fields = dict(spec["problem"])
    for key in ("darcy_solver", "sampler_solver"):
        if key in fields:
            fields[key] = SolverConfig(**fields[key])
    fields.update(seed=int(seed), output_filename="", **overrides)
    for key in ("ncells", "lengths", "ess_attr", "obs_attr", "inflow_attr", "qoi_point",
                "n_buffer"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return ProblemConfig(**fields)


def permeability(spec: dict) -> Optional[np.ndarray]:
    """The configuration's static inverse permeability (n_s, d), made by
    the generator file it names under benchmark/configs/, or None."""
    perm = spec.get("permeability")
    if not perm:
        return None
    path = os.path.join(HERE, "configs", perm["generator"] + ".py")
    mod_spec = importlib.util.spec_from_file_location("perm_" + perm["generator"], path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return 1.0 / mod.permeability(tuple(perm["ncells"]), int(perm["seed"]))


def build(spec: dict, traffic: dict, device) -> dict:
    """The port's problem for a configuration and mix: config, problem and
    the static inverse permeability (on the original axes)."""
    from parelagmc_tpu_torch.problems import build_problem

    if traffic["kind"] != "level_steps":
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    overrides = {"batch_size": int(traffic["batch"])}
    if spec["problem"].get("batch_size_per_level"):
        bpl = list(spec["problem"]["batch_size_per_level"])
        bpl[traffic["level"]] = int(traffic["batch"])
        overrides = {"batch_size_per_level": bpl}
    cfg = problem_config(spec, **overrides)
    kinv = permeability(spec)
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    return {"config": prob.config, "problem": prob, "kinv": kinv}


class Recorder:
    """Instruments the sampler and solver objects a manager is handed."""

    def __init__(self, sampler, solver, traced: bool, device="cpu"):
        self.traced = traced
        self.device = device
        self.spans: List[tuple] = []  # (name, t0, t1, depth, unit)
        self.calls: List[dict] = []  # top-level solves: level, q, qc, conv, iters
        self.solves: List[tuple] = []  # every solve: unit, level, iterations, unconverged
        self.keys: List[tuple] = []  # (unit, level, key)
        # Fields w = exp(s) the sampler returned after the noise draws of
        # these ordinals: (ordinal, level, noise level, tensor).
        self.keep_fields: set = set()
        self.fields: List[tuple] = []
        self._noise: Dict[int, int] = {}  # id of a noise draw -> its ordinal
        self.unit = -1
        self.depth = 0
        self.active = True
        self._wrap(sampler, "sample", "sampler", self._on_sample)
        self._wrap(sampler, "eval", "sampler", self._on_eval)
        if hasattr(sampler, "eval_pair"):
            self._wrap(sampler, "eval_pair", "sampler", self._on_eval_pair)
        self._wrap(solver, "solve_fwd_pair", "darcy", self._on_pair)
        self._wrap(solver, "solve_fwd", "solve", self._on_solve)
        self._wrap(solver, "solve_fwd_warm", "solve", self._on_solve)

    def span(self, name: str):
        """A synchronized host span (and profiler range) when traced."""
        if not self.traced or not self.active:
            return nullcontext()
        return _Span(self, name)

    def _wrap(self, obj, method: str, span: str, hook: Optional[Callable] = None) -> None:
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            name = span
            if span == "solve":  # solve.L<level>.b<batch>: the shape K1 ran at
                w = args[1]
                name = f"solve.L{args[0]}.b{w.numel() // w.shape[-1]}"
            self.depth += 1
            try:
                with self.span(name):
                    out = inner(*args, **kwargs)
            finally:
                self.depth -= 1
            if hook is not None and self.active:
                hook(args, kwargs, out)
            return out

        setattr(obj, method, wrapped)

    def _on_sample(self, args, kwargs, out) -> None:
        level, key = args[0], args[1]
        self._noise[id(out)] = len(self.keys)
        self.keys.append((self.unit, int(level), (int(key[0]), int(key[1]))))

    def _on_eval(self, args, kwargs, out) -> None:
        ordinal = self._noise.get(id(args[1]))
        if ordinal in self.keep_fields:
            level = int(args[0])
            xi_level = args[2] if len(args) > 2 else kwargs.get("xi_level")
            self.fields.append((ordinal, level, level if xi_level is None else int(xi_level),
                                out))

    def _on_eval_pair(self, args, kwargs, out) -> None:
        ordinal = self._noise.get(id(args[1]))
        if ordinal in self.keep_fields:
            level = int(args[0])
            self.fields.append((ordinal, level, level, out[0]))
            self.fields.append((ordinal, level + 1, level, out[1]))

    def _on_pair(self, args, kwargs, out) -> None:
        q, qc, info_f, info_c = out
        if self.depth == 0:
            self.calls.append(dict(unit=self.unit, level=int(args[0]), q=q, qc=qc,
                                   conv=info_f.converged & info_c.converged,
                                   iters=info_f.iterations + info_c.iterations))

    def _on_solve(self, args, kwargs, out) -> None:
        info = out[2]
        self.solves.append((self.unit, int(args[0]), int(info.iterations),
                            int((~info.converged).sum())))
        if self.depth == 0:
            self.calls.append(dict(unit=self.unit, level=int(args[0]), q=out[0], qc=None,
                                   conv=info.converged, iters=int(info.iterations)))


class _Span:
    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        sync(self.rec.device)
        self.range = torch.profiler.record_function("bench." + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.rec.device)
        t1 = time.perf_counter()
        self.range.__exit__(*exc)
        self.rec.spans.append((self.name, self.t0, t1, self.rec.depth, self.rec.unit))
        return False


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Traffic:
    """A mix's units on one problem: `warm()` runs every shape once (out of
    band, not recorded), `unit(k)` runs the k-th unit of the window and
    returns the samples it completed."""

    def __init__(self, built: dict, traffic: dict, seed: int, rec: Recorder):
        self.prob = built["problem"]
        self.cfg = built["config"]
        self.seed = int(seed)
        self.rec = rec
        self.level = int(traffic["level"])
        self.batch = int(traffic["batch"])
        self.mgr = self._manager(self.seed)

    def _manager(self, seed: int):
        from parelagmc_tpu_torch.uq import MLMCManager

        return MLMCManager(self.prob.solver, self.prob.sampler,
                           dataclasses.replace(self.cfg, seed=int(seed)))

    def counts(self) -> List[int]:
        n = [0] * self.cfg.nlevels
        n[self.level] = self.batch
        return n

    def warm(self) -> None:
        """Two batches of the level step (the first builds state at first
        use), keyed out of band; the recorder is off."""
        self.rec.active = False
        try:
            mgr = self._manager(self.seed + 2 ** 40)
            for _ in range(2):
                mgr.init_run(self.counts())
            sync(self.prob.device)
        finally:
            self.rec.active = True

    def unit(self, k: int) -> int:
        """Run unit k; the samples it completed."""
        self.rec.unit = k
        with self.rec.span("unit"):
            self.mgr.init_run(self.counts())
        return self.batch


def run_window(traffic: Traffic, seconds: float, profile_units: int = 0) -> dict:
    """Units back to back until `seconds` have passed. With profile_units
    > 0 the first that many units run under torch.profiler. Returns the
    units' (t0, t1, samples) and the profiler, if any."""
    units = []
    prof = None
    start = time.perf_counter()
    k = 0
    while True:
        if k == 0 and profile_units > 0:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        n = traffic.unit(k)
        t1 = time.perf_counter()
        units.append((t0, t1, n))
        k += 1
        if prof is not None and k == profile_units:
            prof.__exit__(None, None, None)
        if t1 - start >= seconds:
            break
    if prof is not None and k < profile_units:
        prof.__exit__(None, None, None)
    return {"units": units, "profiler": prof, "profile_units": min(k, profile_units)}
