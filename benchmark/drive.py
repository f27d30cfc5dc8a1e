"""What every traffic-mix kind shares: the port's problem of a
configuration file, the `Recorder` that instruments the objects the program
is handed, and the window that runs a kind's units.

A mix's `kind` names a module `benchmark/kinds/<kind>.py` (loaded by
`harness.load_kind`) that builds the problem, tells the `Recorder` which of
the port's methods to wrap, runs the units, plants the faults and makes the
check; see `harness.KIND_EXPORTS`. Every mix is a closed loop: the next
unit starts when the last has returned. The window runs units until
`seconds` have passed and ends with the last unit begun before then.

`Recorder.wrap` replaces a method on an object (an instance attribute, no
file of the port changes): in a traced run a synchronized span around each
call (also a profiler range named `bench.<span>`), and after each call a
hook that keeps what the check and the metric readers need: the noise keys
and kept fields (`wrap_sampler`), every solve's iterations (`on_solve`),
and the top-level calls, one a batch.
"""

from __future__ import annotations

import importlib.util
import os
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Union

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


def build_problem(spec: dict, device, **overrides) -> dict:
    """The port's problem for a configuration file: `config`, `problem`
    (the port's `build_problem` result) and `kinv`, the static inverse
    permeability on the original axes, or None. `overrides` go to the
    ProblemConfig."""
    from parelagmc_tpu_torch.problems import build_problem as port_build

    cfg = problem_config(spec, **overrides)
    kinv = permeability(spec)
    prob = port_build(cfg, kinv_ref=kinv, device=device)
    return {"config": prob.config, "problem": prob, "kinv": kinv}


class Recorder:
    """Instruments the objects a program is handed; a kind chooses what it
    wraps (`wrap`, `wrap_sampler`) and with which hooks."""

    def __init__(self, traced: bool, device="cpu"):
        self.traced = traced
        self.device = device
        self.spans: List[tuple] = []  # (name, t0, t1, depth, unit)
        self.calls: List[dict] = []  # top-level calls, one a batch: unit, level, ... (the kind's)
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

    def clear(self) -> None:
        """Forget what the last window recorded."""
        for records in (self.spans, self.calls, self.solves, self.keys, self.fields):
            records.clear()
        self._noise.clear()

    def span(self, name: str):
        """A synchronized host span (and profiler range) when traced."""
        if not self.traced or not self.active:
            return nullcontext()
        return _Span(self, name)

    def wrap(self, obj, method: str, span: Union[str, Callable[[tuple], str]],
             hook: Optional[Callable] = None) -> None:
        """Replace obj.method by a call inside the span `span` (or the name
        `span(args)` gives) that then passes (args, kwargs, output) to
        `hook` while the recorder is active."""
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            name = span if isinstance(span, str) else span(args)
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

    def wrap_sampler(self, sampler) -> None:
        """The SPDE sampler's draws (keys) and evaluations (kept fields),
        in the span `sampler`."""
        self.wrap(sampler, "sample", "sampler", self.on_sample)
        self.wrap(sampler, "eval", "sampler", self.on_eval)
        if hasattr(sampler, "eval_pair"):
            self.wrap(sampler, "eval_pair", "sampler", self.on_eval_pair)

    def on_sample(self, args, kwargs, out) -> None:
        level, key = args[0], args[1]
        self._noise[id(out)] = len(self.keys)
        self.keys.append((self.unit, int(level), (int(key[0]), int(key[1]))))

    def on_eval(self, args, kwargs, out) -> None:
        ordinal = self._noise.get(id(args[1]))
        if ordinal in self.keep_fields:
            level = int(args[0])
            xi_level = args[2] if len(args) > 2 else kwargs.get("xi_level")
            self.fields.append((ordinal, level, level if xi_level is None else int(xi_level),
                                out))

    def on_eval_pair(self, args, kwargs, out) -> None:
        ordinal = self._noise.get(id(args[1]))
        if ordinal in self.keep_fields:
            level = int(args[0])
            self.fields.append((ordinal, level, level, out[0]))
            self.fields.append((ordinal, level + 1, level, out[1]))

    def on_solve(self, args, kwargs, out) -> None:
        """A Darcy solve's (Q, cost, info, ...): its iterations, and at the
        top level a call of its own."""
        info = out[2]
        self.solves.append((self.unit, int(args[0]), int(info.iterations),
                            int((~info.converged).sum())))
        if self.depth == 0:
            self.calls.append(dict(unit=self.unit, level=int(args[0]), q=out[0], qc=None,
                                   conv=info.converged, iters=int(info.iterations)))


def solve_span(args) -> str:
    """solve.L<level>.b<batch> of a solve's (level, w, ...): the shape K1
    ran at."""
    w = args[1]
    return f"solve.L{args[0]}.b{w.numel() // w.shape[-1]}"


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


def run_window(traffic, seconds: float, profile_units: int = 0) -> dict:
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
