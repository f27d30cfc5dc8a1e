"""Faults planted in the timed path, for the harness's tests and the
control's readings. Each wraps the solver's `solve_fwd_pair`, where a
batch's Q values are produced:

* "stale": every batch returns the first batch's values (a step that
  returns its state unchanged);
* "half": the second half of each batch's Q replaced by the mean of the
  first half (half of the batch left out, the mean taken over the rest);
* "altered": every Q times 1 + `rel` (an answer altered where it is
  produced).

One card has no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Callable, Optional

FAULTS = ("stale", "half", "altered")


def install(problem, fault: Callable[[], Optional[str]], rel: float = 0.05) -> None:
    """Wrap the problem's solver; `fault()` names the fault in force at
    each call, or None."""
    solver = problem.solver
    inner = solver.solve_fwd_pair
    first = []

    def pair(*args, **kwargs):
        out = inner(*args, **kwargs)
        name = fault()
        if name == "stale":
            if not first:
                first.append(out)
            return first[0]
        q, qc, info_f, info_c = out
        if name == "half":
            n = q.shape[0] // 2
            q = q.clone()
            q[n:] = q[:n].mean()
        elif name == "altered":
            q = q * (1.0 + rel)
        elif name is not None:
            raise ValueError(f"unknown fault {name!r}")
        return q, qc, info_f, info_c

    solver.solve_fwd_pair = pair
