"""Faults planted in the timed path, for the harness's tests and the
control's readings. A kind's `plant` names the method that produces its
answers and which output they are; `install` wraps it so that:

* "stale": every call returns the first call's output (a step that
  returns its state unchanged);
* "half": the second half of the batch's answers replaced by the mean of
  the first half (half of the batch left out, the mean taken over the
  rest);
* "altered": every answer times 1 + `rel` (an answer altered where it is
  produced).

One card has no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Callable, Optional

FAULTS = ("stale", "half", "altered")


def install(obj, method: str, fault: Callable[[], Optional[str]], index: int = 0,
            rel: float = 0.05) -> None:
    """Wrap obj.method, whose output's item `index` holds a batch's
    answers; `fault()` names the fault in force at each call, or None."""
    inner = getattr(obj, method)
    first = []

    def faulty(*args, **kwargs):
        out = inner(*args, **kwargs)
        name = fault()
        if name is None:
            return out
        if name == "stale":
            if not first:
                first.append(out)
            return first[0]
        x = out[index]
        if name == "half":
            n = x.shape[0] // 2
            x = x.clone()
            x[n:] = x[:n].mean()
        elif name == "altered":
            x = x * (1.0 + rel)
        else:
            raise ValueError(f"unknown fault {name!r}")
        return out[:index] + (x,) + out[index + 1:]

    setattr(obj, method, faulty)
