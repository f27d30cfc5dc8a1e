"""The comparison that decides `correct`, as far as every traffic-mix kind
shares it: the plain reference's Darcy solve (`solver_for`), the key of
MLMC's schedule, the picks of batches and rows, the field, Q and sum gaps,
and the judgement against a cell's limits (benchmark/limits/<cell>.json).
Each kind's `check` (benchmark/kinds/<kind>.py) says which numbers it
compares, on what the timed path produced, once the window has closed:

* `field_gap` (`field_gap`): the widest relative gap |w - w_ref| / w_ref of
  the SPDE coefficient fields w = exp(s) the sampler returned for a few
  noise draws (`field_ordinals`), over rows drawn from the seed: the K2
  noise and the field. The reference draws the noise from its own copy of
  the threefry stream (reference/threefry.py) with the key of the draw.
* Q gaps (`compare`): |Q - Q_ref| / |Q_ref| over picked rows of picked
  batches (`choose`), the reference making the field and solving the
  Darcy system itself.
* `sum_gap` (`sum_gap`): what the program formed from the per-sample
  values against the same formed from the values it returned.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

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
    """The key of an MLMC manager's batch: fold_in(fold_in(PRNGKey(seed),
    level), counter), the counter from 1."""
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), level), counter)


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
    (`q`) and coarse (`qc`, or None), of batches drawn with the key
    `schedule`. With `control`, the reference solved by it stands in the
    program's place."""
    gaps = []
    for i, rows in picks:
        b = batches[i]
        key = b["schedule"]
        for level, got in ((b["level"], b["q"]), (b["level"] + 1, b["qc"])):
            if got is None:
                continue
            w = ref.coefficients(key, b["q"].size, rows, b["level"], level, prec)
            want = ref.q(level, w, solve)
            got = ref.q(level, w, control) if control is not None else got[rows]
            gaps.append(np.abs(got - want) / np.abs(want))
    gaps = np.concatenate(gaps)
    return float(np.max(gaps)), float(np.mean(gaps))


def sum_gap(program_sum: float, parts: Iterable[float]) -> float:
    """What the program formed (a sum over samples) against the same
    formed here, the sum of `parts`, as a share of the latter."""
    y = sum(parts)
    return abs(float(program_sum) - y) / max(abs(y), 1e-300)


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
