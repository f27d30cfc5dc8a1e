"""Traffic kind "level_steps" (`level`, `batch`): back-to-back batches of one
MLMC level step through `MLMCManager.init_run`, the manager keyed from the
run's seed; one unit is one batch. A pair step runs the sampler's draw and
evaluation and the solver's `solve_fwd_pair` (the coarse `solve_fwd`, then
the fine `solve_fwd_warm`); the coarsest level's step a lone `solve_fwd`.

Numbers compared (each against the limit in benchmark/limits/<cell>.json):

* `field_gap`: `verify.field_gap` over `rows` rows of the fields (fine and
  coarse) of `field_batches` of the first `field_span` noise draws.
* `q_mean_gap`: the mean relative gap |Q - Q_ref| / |Q_ref| over `rows`
  rows (all, where a batch has no more) of `batches` of the window's
  batches, fine and coarse Q of each pair: the batch that took the most
  Krylov iterations and others drawn from the seed (`verify.compare`, the
  key of the manager's schedule). `q_gap`, the widest of those gaps, is
  reported beside it; a cell compares what its limits file names.
* `key_miss`: batches whose key is not the schedule's,
  fold_in(fold_in(PRNGKey(seed), level), counter).
* `sum_gap`: the relative gap between the manager's level sum of
  Y = Q - Q_c and the same formed from the values the solver returned.
* `nonfinite`: samples whose Q is not finite.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import drive
import faults
import verify
from reference.mixed import Precision
from reference.problem import ReferenceProblem

field_ordinals = verify.field_ordinals


def build(spec: dict, traffic: dict, device) -> dict:
    """The configuration's problem with the mix's batch at its level."""
    overrides = {"batch_size": int(traffic["batch"])}
    if spec["problem"].get("batch_size_per_level"):
        bpl = list(spec["problem"]["batch_size_per_level"])
        bpl[traffic["level"]] = int(traffic["batch"])
        overrides = {"batch_size_per_level": bpl}
    return drive.build_problem(spec, device, **overrides)


def instrument(rec, built: dict) -> None:
    """The sampler; the pair solve (span `darcy`, one call a batch) and
    each level solve inside it (`solve.L<l>.b<b>`)."""
    solver = built["problem"].solver
    rec.wrap_sampler(built["problem"].sampler)

    def on_pair(args, kwargs, out) -> None:
        q, qc, info_f, info_c = out
        if rec.depth == 0:
            rec.calls.append(dict(unit=rec.unit, level=int(args[0]), q=q, qc=qc,
                                  conv=info_f.converged & info_c.converged,
                                  iters=info_f.iterations + info_c.iterations))

    rec.wrap(solver, "solve_fwd_pair", "darcy", on_pair)
    rec.wrap(solver, "solve_fwd", drive.solve_span, rec.on_solve)
    rec.wrap(solver, "solve_fwd_warm", drive.solve_span, rec.on_solve)


def plant(problem, fault, rel: float = 0.05) -> None:
    """The faults on the fine Q of the pair solve, where a batch's Q
    values are produced."""
    faults.install(problem.solver, "solve_fwd_pair", fault, index=0, rel=rel)


class Traffic:
    """A mix's units on one problem: `warm()` runs every shape once (out of
    band, not recorded), `unit(k)` runs the k-th unit of the window and
    returns the samples it completed."""

    def __init__(self, built: dict, traffic: dict, seed: int, rec):
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
            drive.sync(self.prob.device)
        finally:
            self.rec.active = True

    def unit(self, k: int) -> int:
        """Run unit k; the samples it completed."""
        self.rec.unit = k
        with self.rec.span("unit"):
            self.mgr.init_run(self.counts())
        return self.batch


def keep(traffic: Traffic) -> dict:
    """What the check needs of the program's state: the seed, and the
    manager's level sum of Y."""
    return {"seed": traffic.seed, "manager_sum": float(traffic.mgr.sums[traffic.level, 0])}


def reference(spec: dict, kinv: Optional[np.ndarray]) -> ReferenceProblem:
    return ReferenceProblem(spec, kinv=kinv)


def batches_of(rec, seed: int) -> List[dict]:
    """The window's batches in order: level, key, q, qc, converged, and the
    key the schedule gives them (one manager over the whole window: one
    counter)."""
    return [dict(unit=unit, level=call["level"], key=key,
                 schedule=verify.schedule_key(seed, call["level"], i + 1),
                 q=verify.host(call["q"]),
                 qc=None if call["qc"] is None else verify.host(call["qc"]),
                 conv=verify.host(call["conv"]).astype(bool), iters=call["iters"])
            for i, (call, (unit, _, key)) in enumerate(zip(rec.calls, rec.keys))]


def check(spec: dict, kinv: Optional[np.ndarray], rec, kept: dict, check_spec: dict,
          device="cpu", ref: Optional[ReferenceProblem] = None, control: bool = False) -> dict:
    """The compared numbers of a run, and the counts of the result line;
    the reference computes on `device`. With `control`, the reference's CG
    in bfloat16 (`verify.solver_for`) stands in the program's place for the
    checked samples."""
    seed = kept["seed"]
    batches = batches_of(rec, seed)
    keys_ok = [tuple(b["key"]) == b["schedule"] for b in batches]
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    picks = verify.choose(batches, int(check_spec["batches"]), int(check_spec["rows"]), rng)
    ref = ref or reference(spec, kinv)
    prec = Precision(device=device)
    q_gap, q_mean_gap = verify.compare(
        ref, batches, picks, verify.solver_for(device), prec,
        verify.solver_for(device, storage="bfloat16") if control else None)
    f_gap = verify.field_gap(rec, ref, int(check_spec["rows"]), seed, prec)
    qs = [b["q"] for b in batches] + [b["qc"] for b in batches if b["qc"] is not None]
    nonfinite = int(sum(np.sum(~np.isfinite(q)) for q in qs))
    failed = int(sum(np.sum(~b["conv"] | ~np.isfinite(b["q"])) for b in batches))
    y = [float(np.sum(b["q"] - (0.0 if b["qc"] is None else b["qc"]))) for b in batches]
    return {
        "numbers": {"field_gap": f_gap, "q_mean_gap": q_mean_gap, "q_gap": q_gap,
                    "key_miss": int(len(keys_ok) - sum(keys_ok)),
                    "sum_gap": verify.sum_gap(kept["manager_sum"], y),
                    "nonfinite": nonfinite},
        "attempted": int(sum(b["q"].size for b in batches)),
        "failed": failed,
        "checked": [(batches[i]["level"], len(rows)) for i, rows in picks],
    }
