"""Spans and counters of the port's level step.

A span is a named stretch of host time: `time.perf_counter_ns()` at its
start and end, the index of the span it opened in (a stack), the batch it
ran in (the manager's `(level, key counter)`, shared by every span of the
batch) and a few attributes (level, rows, role, start, grid level,
iterations). Spans are recorded only while a torch.profiler session is
recording or PARELAGMC_BATCH_TRACE is set; otherwise `span` is one
module-global check that hands back a shared no-op object. A span never
synchronizes the device and never enters `torch.profiler.record_function`,
so it adds no range to a profiler's device timeline: it times the host,
and a reader puts it on the device timeline by the host clock.

Spans land in a bounded buffer (`CAPACITY`); the oldest are dropped
first and counted in the counter `trace.dropped`. `spans()` hands out
what the buffer holds, `reset()` empties it.

Counters are plain integer adds, always on, in named groups of a dict
each: `kernel` (the launches of the CUDA kernels; the dict is
`kernels.launch_counts`), `krylov` (`iterations`, loop trips;
`restarts`; `extra_iterations`, the trips a PCG with a `loose_rtol` ran
after every row had met it), `host_syncs` (one per entry of a `wait` site, by site),
`coefmg` (the structured V-cycle's `graph_captures`, `graph_replays`,
`eager_cycles`; ops/coef_multigrid_structured.py) and `trace` (`dropped`).
`counter_values()` flattens them to `group.name`.

PARELAGMC_BATCH_TRACE=1 (read once, at import) also makes each manager
print one stderr line per batch from its `mlmc.batch` span
(`batch_totals`, `batch_line_totals`).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _profiler

BATCH_TRACE = os.environ.get("PARELAGMC_BATCH_TRACE", "").strip().lower() in {
    "1", "true", "yes", "on",
}
CAPACITY = 1 << 16

_groups: Dict[str, Dict[str, int]] = {}


def counters(group: str, names: Iterable[str] = ()) -> Dict[str, int]:
    """The live counter dict of `group`, made at first use, with `names`
    at 0. Callers add to it in place."""
    d = _groups.setdefault(group, {})
    for n in names:
        d.setdefault(n, 0)
    return d


def counter_values() -> Dict[str, int]:
    """Every counter now, as {"group.name": value}."""
    return {f"{g}.{k}": v for g, d in _groups.items() for k, v in d.items()}


_KRYLOV = counters("krylov", ("iterations", "restarts", "extra_iterations"))
_COEFMG = counters("coefmg", ("graph_captures", "graph_replays", "eager_cycles"))
_SYNCS = counters("host_syncs")
_TRACE = counters("trace", ("dropped",))


class Span:
    """One span. `index` numbers every span of the process, so `parent`
    (-1 at the top) names its parent even after the buffer has dropped it.
    `t1` is 0 while the span is open. A span being recorded is its own
    context manager; `note(key, value)` sets an attribute."""

    __slots__ = ("name", "index", "parent", "batch", "t0", "t1", "attrs", "_outer", "_before")

    def __init__(self, name: str, index: int, parent: int, batch, attrs: dict):
        self.name, self.index, self.parent, self.batch = name, index, parent, batch
        self.attrs = attrs
        self.t0 = self.t1 = 0
        self._outer = self._before = None

    def __enter__(self):
        if len(_buffer) == CAPACITY:
            _TRACE["dropped"] += 1
        _buffer.append(self)
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _batch
        self.t1 = time.perf_counter_ns()
        _stack.pop()
        if self._before is not None:
            before = self._before
            self.attrs["counters"] = {k: v - before.get(k, 0)
                                      for k, v in counter_values().items()
                                      if v != before.get(k, 0)}
        _batch = self._outer
        return False

    def note(self, key: str, value) -> None:
        self.attrs[key] = value


_buffer: Deque[Span] = deque(maxlen=CAPACITY)
_stack: List[Span] = []
_batch: Optional[Tuple[int, int]] = None
_next = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, key: str, value) -> None:
        pass


_OFF = _Off()


def _open(name: str, attrs: dict, batch) -> Span:
    """A new span under the innermost open one, taking its `level` if it
    has none; `batch` opens a batch and keeps the counters to diff."""
    global _next, _batch
    parent = _stack[-1] if _stack else None
    if "level" not in attrs and parent is not None and "level" in parent.attrs:
        attrs["level"] = parent.attrs["level"]
    outer = _batch
    if batch is not None:
        _batch = batch
    sp = Span(name, _next, parent.index if parent is not None else -1, _batch, attrs)
    sp._outer = outer
    if batch is not None:
        sp._before = counter_values()
    _next += 1
    return sp


def span(name: str, batch: Optional[Tuple[int, int]] = None, **attrs):
    """A context manager around one stretch of the host's work, with
    integer or string attributes (level, rows, role, start, grid). `batch`
    opens a batch: every span inside shares it, and the span records each
    counter's change over it (attribute `counters`). A span without
    `level` takes its parent's."""
    if not (BATCH_TRACE or _profiler._is_profiler_enabled):
        return _OFF
    return _open(name, attrs, batch)


def wait(site: str):
    """A blocking device-to-host read at `site`: counts `host_syncs.<site>`
    and, when on, is the span `wait.<site>`."""
    _SYNCS[site] = _SYNCS.get(site, 0) + 1
    if not (BATCH_TRACE or _profiler._is_profiler_enabled):
        return _OFF
    return _open("wait." + site, {}, None)


def read_bool(site: str, flag) -> bool:
    """`bool(flag)` of a device tensor, as the wait `site`."""
    with wait(site):
        return bool(flag)


def spans() -> List[Span]:
    """The buffer's spans, oldest first (in the order they started)."""
    return list(_buffer)


def reset() -> None:
    """Empty the buffer and zero `trace.dropped`."""
    _buffer.clear()
    _TRACE["dropped"] = 0


def batch_totals(batch_span: Span) -> Dict[str, float]:
    """Of a closed batch span: the summed wall of its `darcy.setup`,
    `krylov.pcg` and `wait.*` spans in ms, its `host_syncs` and its Krylov
    `restarts`."""
    ns = {"setup_ms": 0, "krylov_ms": 0, "wait_ms": 0}
    for s in reversed(_buffer):
        if s.index <= batch_span.index:
            break
        if s.batch != batch_span.batch:
            continue
        key = ("setup_ms" if s.name == "darcy.setup" else "krylov_ms" if s.name == "krylov.pcg"
               else "wait_ms" if s.name.startswith("wait.") else None)
        if key is not None:
            ns[key] += s.t1 - s.t0
    out: Dict[str, float] = {k: v * 1e-6 for k, v in ns.items()}
    delta = batch_span.attrs.get("counters", {})
    out["host_syncs"] = sum(v for k, v in delta.items() if k.startswith("host_syncs."))
    out["restarts"] = delta.get("krylov.restarts", 0)
    return out


def batch_line_totals(batch_span: Span) -> str:
    """The shared tail of a manager's `# batch-trace` line: the wall clock
    and `batch_totals` of a closed batch span."""
    totals = batch_totals(batch_span)
    return (f"t={time.strftime('%H:%M:%S')} "
            f"setup_ms={totals['setup_ms']:.3f} "
            f"krylov_ms={totals['krylov_ms']:.3f} "
            f"wait_ms={totals['wait_ms']:.3f} "
            f"host_syncs={totals['host_syncs']} "
            f"restarts={totals['restarts']}")
