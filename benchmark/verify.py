"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (benchmark/reference/), once the window has
closed.

Numbers compared (each against the limit in benchmark/limits/<cell>.json):

* `field_gap`: the widest relative gap |w - w_ref| / w_ref of the SPDE
  coefficient fields w = exp(s) the sampler returned for a few noise draws
  (fine and coarse), drawn from the seed, over `rows` rows of each, drawn
  from the seed: the K2 noise and the field.
* `q_mean_gap`: the mean relative gap |Q - Q_ref| / |Q_ref| over `rows`
  rows (all, where a batch has no more) of `batches` of the window's
  batches, fine and coarse Q of each pair: the batch that took the most
  Krylov iterations and others drawn from the seed. The reference draws
  the noise from its own copy of the threefry stream with the key the
  manager's schedule gives, makes the SPDE field and solves the Darcy
  system itself. `q_gap`, the widest of those gaps, is reported beside
  it; a cell compares what its limits file names.
* `key_miss`: batches whose key is not the schedule's,
  fold_in(fold_in(PRNGKey(seed), level), counter).
* `sum_gap`: the relative gap between what the manager formed from the
  per-sample values (its level sum of Y = Q - Q_c) and the same formed
  from the values the solver returned.
* `nonfinite`: samples whose Q is not finite.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from reference import threefry
from reference.mixed import Precision
from reference.problem import ReferenceProblem


def host(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def schedule_key(seed: int, level: int, counter: int):
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), level), counter)


def batches_of(rec, traffic) -> List[dict]:
    """The window's batches in order: level, key, q, qc, converged, the
    manager seed and counter the schedule gives them (one manager over the
    whole window: one counter)."""
    return [dict(unit=unit, level=call["level"], key=key, seed=traffic.seed, counter=i + 1,
                 q=host(call["q"]), qc=None if call["qc"] is None else host(call["qc"]),
                 conv=host(call["conv"]).astype(bool), iters=call["iters"])
            for i, (call, (unit, level, key)) in enumerate(zip(rec.calls, rec.keys))]


def choose(batches: List[dict], nbatches: int, nrows: int, rng) -> List[tuple]:
    """(batch, rows) to check: the batch with the most iterations and
    others drawn from the seed; `nrows` rows of each drawn from the seed,
    or all of them."""
    picked = [int(np.argmax([b["iters"] for b in batches]))]
    rest = [i for i in range(len(batches)) if i not in picked]
    while len(picked) < nbatches and rest:
        picked.append(rest.pop(int(rng.integers(len(rest)))))
    out = []
    for i in picked:
        n = batches[i]["q"].size
        out.append((i, sorted(rng.choice(n, size=min(nrows, n), replace=False).tolist())))
    return out


def compare(ref: ReferenceProblem, batches: List[dict], picks: List[tuple], solve: Callable,
            prec: Precision, control: Optional[Callable] = None) -> tuple:
    """(widest, mean) of |Q - Q_ref| / |Q_ref| over the picked rows, fine
    and coarse. With `control`, the reference solved by it stands in the
    program's place."""
    gaps = []
    for i, rows in picks:
        b = batches[i]
        key = schedule_key(b["seed"], b["level"], b["counter"])
        for level, got in ((b["level"], b["q"]), (b["level"] + 1, b["qc"])):
            if got is None:
                continue
            w = ref.coefficients(key, b["q"].size, rows, b["level"], level, prec)
            want = ref.q(level, w, solve)
            got = ref.q(level, w, control) if control is not None else got[rows]
            gaps.append(np.abs(got - want) / np.abs(want))
    gaps = np.concatenate(gaps)
    return float(np.max(gaps)), float(np.mean(gaps))


def sum_gap(batches: List[dict], manager_sum: float) -> float:
    """The manager's level sum of Y against the same formed here."""
    y = sum(float(np.sum(b["q"] - (0.0 if b["qc"] is None else b["qc"]))) for b in batches)
    return abs(float(manager_sum) - y) / max(abs(y), 1e-300)


def check(spec: dict, kinv: Optional[np.ndarray], rec, traffic, check_spec: dict,
          manager_sum: float, device="cpu", ref: Optional[ReferenceProblem] = None,
          control: Optional[Callable] = None) -> dict:
    """The compared numbers of a run, and the counts of the result line;
    the reference computes on `device`."""
    batches = batches_of(rec, traffic)
    keys_ok = [tuple(b["key"]) == schedule_key(b["seed"], b["level"], b["counter"])
               for b in batches]
    rng = np.random.default_rng(int(traffic.seed) % 2 ** 63)
    picks = choose(batches, int(check_spec["batches"]), int(check_spec["rows"]), rng)
    ref = ref or ReferenceProblem(spec, kinv=kinv)
    prec = Precision(device=device)
    q_gap, q_mean_gap = compare(ref, batches, picks, solver_for(device), prec, control)
    f_gap = field_gap(rec, ref, int(check_spec["rows"]), traffic.seed, prec)
    qs = [b["q"] for b in batches] + [b["qc"] for b in batches if b["qc"] is not None]
    nonfinite = int(sum(np.sum(~np.isfinite(q)) for q in qs))
    failed = int(sum(np.sum(~b["conv"] | ~np.isfinite(b["q"])) for b in batches))
    return {
        "numbers": {"field_gap": f_gap, "q_mean_gap": q_mean_gap, "q_gap": q_gap,
                    "key_miss": int(len(keys_ok) - sum(keys_ok)),
                    "sum_gap": sum_gap(batches, manager_sum),
                    "nonfinite": nonfinite},
        "attempted": int(sum(b["q"].size for b in batches)),
        "failed": failed,
        "checked": [(batches[i]["level"], len(rows)) for i, rows in picks],
    }


def manager_sum(traffic) -> float:
    """What the manager formed: its level sum of Y."""
    return float(traffic.mgr.sums[traffic.level, 0])


def field_ordinals(check_spec: dict, seed: int) -> set:
    """The noise draws (in order from 0) whose fields the check compares:
    `field_batches` of the first `field_span`, drawn from the seed."""
    rng = np.random.default_rng((int(seed) + 7) % 2 ** 63)
    span = int(check_spec.get("field_span", 6))
    n = min(int(check_spec.get("field_batches", 2)), span)
    return set(int(x) for x in rng.choice(span, size=n, replace=False))


def field_gap(rec, ref: ReferenceProblem, nrows: int, seed: int, prec: Precision) -> float:
    """Widest relative gap |w - w_ref| / w_ref of the SPDE fields kept by
    the recorder, over rows drawn from the seed and all their cells; the
    reference draws the noise with the key the draw was keyed with."""
    rng = np.random.default_rng((int(seed) + 11) % 2 ** 63)
    gap = 0.0
    for ordinal, level, xi_level, w in rec.fields:
        key = rec.keys[ordinal][2]
        w = host(w)
        rows = sorted(rng.choice(w.shape[0], size=min(nrows, w.shape[0]), replace=False))
        w_ref = ref.coefficients(key, w.shape[0], rows, xi_level, level, prec)
        gap = max(gap, float(np.max(np.abs(w[rows] - w_ref) / w_ref)))
    return gap


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: [value, limit]})."""
    checks = {k: [numbers[k], limits[k]] for k in limits}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    return bool(ok), checks


# The control's solve: the program's budget for one solve (75 iterations
# in each of 4 segments).
CONTROL_ITERS = 300


def solver_for(device, direct_max: int = 50_000, storage: str = "float64") -> Callable:
    """The reference's Darcy solve, Q of each row of w: a sparse LU for a
    level of up to `direct_max` unknowns, MG-preconditioned CG (plain
    PyTorch, float64, on `device`) above. With `storage="bfloat16"` (the
    control) always the CG, its values in bfloat16, stopped after
    CONTROL_ITERS iterations at the most."""

    def solve(dl, w):
        if storage == "float64" and dl.active.size + dl.lvl.n_s <= direct_max:
            return np.array([dl.solve(wi)[0] for wi in w])
        from reference import krylov

        if storage == "float64":
            return krylov.solve(dl, w, device)
        return krylov.solve(dl, w, device, storage=storage, max_iters=CONTROL_ITERS)

    return solve
