"""The program's own spans in a traced run, on the profiler's clock.

parelagmc_tpu_torch.utils.trace records spans on the host clock
(`time.perf_counter_ns`) while a torch.profiler session records, so a
traced run leaves the spans of its profiled units in the tracer's buffer.
Each profiled unit is both a Recorder span `unit` (`time.perf_counter`,
the same clock) and a profiler range `bench.unit` (microseconds on the
profiler's clock); each pair gives that unit's offset between the clocks.
Where the program has no tracer, every reader here returns None.

The idle split is tracedata.breakdown's own arithmetic (the gaps between
the merged device operations of the profiled window, each put whole to the
innermost range open at its midpoint), run with the program's spans as the
ranges.

`report(run)` is the profiled window's device idle seconds by innermost
program span, their sum beside `window_s - busy_s`, and the profiled
batches' Krylov iterations as the program (`krylov.iterations`) and the
Recorder (`info.iterations`) count them; the reader of
`idle_in_krylov_pct.rate` prints it on standard error in every traced run,
as `# program spans: {...}`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import tracedata


class PSpan(NamedTuple):
    name: str
    start: float  # profiler microseconds
    end: float
    index: int
    parent: int
    batch: Optional[tuple]
    attrs: dict


def program_spans(run) -> Optional[List[PSpan]]:
    """The program's spans that lie inside a profiled unit, in the order
    they started, on the profiler's clock; None without the tracer or a
    profiled unit."""
    try:
        from parelagmc_tpu_torch.utils import trace
    except ImportError:
        return None
    units = {u: (t0, t1) for name, t0, t1, _, u in run.spans
             if name == "unit" and u < run.profile_units}
    ranges = sorted((s, e) for n, s, e in run.ranges if n == "bench.unit")
    if not units or len(ranges) < len(units):
        return None
    # The range opens before the unit's host start and closes after its
    # host end, so each unit bounds the offset (profiler us - host us) from
    # both sides; the first range's opening is slow (the first
    # record_function of the process). Take the middle of the bounds all
    # units share, or each unit's own middle where they share none.
    pairs = [(units[k], s - units[k][0] * 1e6, e - units[k][1] * 1e6)
             for k, (s, e) in enumerate(ranges[:len(units)]) if k in units]
    lo, hi = max(p[1] for p in pairs), min(p[2] for p in pairs)
    offsets = [(u0, u1, 0.5 * (lo + hi) if lo <= hi else 0.5 * (a + b))
               for (u0, u1), a, b in pairs]
    out = []
    for sp in trace.spans():
        t0, t1 = sp.t0 * 1e-9, sp.t1 * 1e-9
        for u0, u1, off in offsets:
            if u0 <= t0 and t1 <= u1:
                out.append(PSpan(sp.name, sp.t0 * 1e-3 + off, sp.t1 * 1e-3 + off, sp.index,
                                 sp.parent, sp.batch, sp.attrs))
                break
    return out


def _batches(spans: List[PSpan]) -> List[PSpan]:
    return [s for s in spans if s.name == "mlmc.batch"]


def host_syncs_per_batch(run) -> Optional[float]:
    """Mean over the profiled batches of the `host_syncs.*` counters'
    change over the `mlmc.batch` span."""
    batches = _batches(program_spans(run) or [])
    if not batches:
        return None
    return sum(v for b in batches for k, v in b.attrs.get("counters", {}).items()
               if k.startswith("host_syncs.")) / len(batches)


def _idle_by_span(run) -> Optional[Tuple[List[PSpan], Dict[str, float]]]:
    """The program's spans, and the profiled window's device idle seconds
    by the innermost of them: tracedata.breakdown on a view of the run
    whose ranges are the profiled units and the spans, each span under its
    position in the list (keys "0", "1", ...; "unit" where the host was in
    a unit but in no span, "outside" between units)."""
    spans = program_spans(run)
    if spans is None:
        return None
    ranges = [r for r in run.ranges if r[0] == "bench.unit"]
    ranges += [(f"bench.{i}", s.start, s.end) for i, s in enumerate(spans)]
    bd = tracedata.breakdown(tracedata.RunData(kernels=run.kernels, ranges=ranges),
                             top=len(ranges) + 1)
    if bd is None:
        return None
    return spans, dict(bd["idle_gaps"])


def idle_by_program_span(run) -> Optional[Dict[str, float]]:
    """Device idle seconds of the profiled window by the name of the
    innermost program span the host was in, largest first."""
    got = _idle_by_span(run)
    if got is None:
        return None
    spans, idle = got
    out: Dict[str, float] = {}
    for key, seconds in idle.items():
        name = spans[int(key)].name if key.isdigit() else key
        out[name] = out.get(name, 0.0) + seconds
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_in_krylov_pct(run) -> Optional[float]:
    """Of the profiled window's device idle time, the % the host spent
    inside a `krylov.iter` and not in its `wait.krylov_test`: idle while
    the loop issued its work."""
    got = _idle_by_span(run)
    total = sum(got[1].values()) if got else 0.0
    if total <= 0:
        return None
    spans, idle = got
    by_index = {s.index: s for s in spans}

    def issuing(s: PSpan) -> bool:
        if s.name == "wait.krylov_test":
            return False
        while s is not None and s.name != "krylov.iter":
            s = by_index.get(s.parent)
        return s is not None

    return 100.0 * sum(v for k, v in idle.items()
                       if k.isdigit() and issuing(spans[int(k)])) / total


def krylov_iterations(run) -> Optional[Tuple[int, int]]:
    """(the program's `krylov.iterations` over the profiled batches, the
    Recorder's iterations of the profiled units' solves)."""
    batches = _batches(program_spans(run) or [])
    if not batches:
        return None
    program = sum(b.attrs.get("counters", {}).get("krylov.iterations", 0) for b in batches)
    return program, tracedata.profiled_iterations(run)


def report(run) -> dict:
    """The idle split and the two counts of Krylov iterations."""
    bi = tracedata.busy_idle(run)
    idle = idle_by_program_span(run)
    return {"idle_by_program_span_s": idle,
            "idle_sum_s": sum(idle.values()) if idle else None,
            "window_minus_busy_s": bi[1] - bi[0] if bi else None,
            "krylov_iterations_program_recorder": krylov_iterations(run)}
