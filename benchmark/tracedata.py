"""What a run hands the metric readers, and the arithmetic they share.

`RunData` holds the window's units (t0, t1, samples), the recorder's spans,
solves and top-level calls, and, in a traced run, the profiled units'
device kernels and `bench.*` ranges on the profiler's clock (microseconds).
The busy and idle arithmetic follows profile_pair_step.py's (kernel time
over a synchronized wall), with the busy time taken as the union of the
kernel intervals, so overlapping kernels count once.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
# Substrings of K1's device functions (csrc/thomas.cu).
K1_KERNELS = ("line_solve_kernel", "segment_solve_kernel")


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


class RunData:
    def __init__(self, **kw):
        # levels: per level n_s, n_u_active (free faces), d
        self.setup_s: float = kw.get("setup_s", 0.0)
        self.units: List[tuple] = kw.get("units", [])
        self.spans: List[tuple] = kw.get("spans", [])
        self.solves: List[tuple] = kw.get("solves", [])
        self.calls: List[dict] = kw.get("calls", [])
        self.kernels: List[tuple] = kw.get("kernels", [])  # (name, start_us, end_us)
        self.ranges: List[tuple] = kw.get("ranges", [])  # (name, start_us, end_us), host
        self.dev_ranges: List[tuple] = kw.get("dev_ranges", [])  # the same, device timeline
        self.profile_units: int = kw.get("profile_units", 0)
        self.levels: List[dict] = kw.get("levels", [])
        self.dtype_bytes: int = kw.get("dtype_bytes", 4)

    # -- window -----------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.units[-1][1] - self.units[0][0]

    def batches(self) -> int:
        """Batches in the window: the manager's top-level solves."""
        return len(self.calls)

    # -- profiled window ----------------------------------------------------------
    def profiled_window(self) -> Optional[Tuple[float, float]]:
        """(start, end) in profiler microseconds of the profiled units."""
        units = sorted((s, e) for n, s, e in self.ranges if n == "bench.unit")
        if not units:
            return None
        return units[0][0], units[-1][1]


def union_length(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_idle(run: RunData) -> Optional[Tuple[float, float]]:
    """(busy_s, window_s) of the profiled window, or None untraced."""
    win = run.profiled_window()
    if win is None or not run.kernels:
        return None
    busy = union_length([(s, e) for _, s, e in run.kernels], *win)
    return busy * 1e-6, (win[1] - win[0]) * 1e-6


def idle_pct(run: RunData) -> Optional[float]:
    bi = busy_idle(run)
    if bi is None or bi[1] <= 0:
        return None
    return 100.0 * (1.0 - bi[0] / bi[1])


def profiled_iterations(run: RunData) -> int:
    return sum(s[2] for s in run.solves if s[0] < run.profile_units)


def launches_per_iter(run: RunData) -> Optional[float]:
    win = run.profiled_window()
    iters = profiled_iterations(run)
    if win is None or iters <= 0 or not run.kernels:
        return None
    n = sum(1 for _, s, e in run.kernels if win[0] <= s <= win[1])
    return n / iters


def per_batch_span_ms(run: RunData, prefixes: Sequence[str]) -> Optional[float]:
    """Mean over batches of the top-level spans whose name starts with one
    of `prefixes`, in ms."""
    nb = run.batches()
    if nb == 0 or not run.spans:
        return None
    total = sum(t1 - t0 for name, t0, t1, depth, _ in run.spans
                if depth == 1 and name.startswith(tuple(prefixes)))
    return 1e3 * total / nb


def k1_apply_bytes(lvl: dict, batch: int, nbytes: int) -> float:
    """Bytes one M(w)^{-1} apply on a level needs, each read or written
    once: the right-hand sides and the solutions on the level's free faces,
    the cell coefficient w, and the level's static mass tables (one
    symmetric 2x2 block, three words, per cell and axis)."""
    return nbytes * (2.0 * batch * lvl["n_u_active"] + batch * lvl["n_s"]
                     + 3.0 * lvl["d"] * lvl["n_s"])


def k1_roofline(run: RunData) -> Optional[float]:
    """Least time of K1's M(w)^{-1} applies (bytes over the HBM peak) over
    K1's summed device time, in %. Each K1 kernel is put to the level and
    batch of the solve range (device timeline) it ran in; three launches
    (one per axis) make one apply."""
    per = k1_by_solve(run)
    if not per:
        return None
    device_s = sum(t for _, t in per.values())
    need = sum(n / 3.0 * k1_apply_bytes(run.levels[l], b, run.dtype_bytes)
               for (l, b), (n, _) in per.items())
    if device_s <= 0 or need <= 0:
        return None
    return 100.0 * (need / (peaks()["hbm_bytes_per_s"])) / device_s


def k1_by_solve(run: RunData) -> Dict[Tuple[int, int], Tuple[int, float]]:
    """Per (level, batch) of the solves: K1 launches and their device
    seconds, each launch put to the solve range (`bench.solve.L<l>.b<n>`,
    device timeline) it ran in."""
    k1 = [(s, e) for n, s, e in run.kernels if any(t in n for t in K1_KERNELS)]
    out: Dict[Tuple[int, int], Tuple[int, float]] = {}
    for name, rs, re_ in run.dev_ranges:
        if not name.startswith("bench.solve.L"):
            continue
        level, batch = name[len("bench.solve.L"):].split(".b")
        inside = [(s, e) for s, e in k1 if rs <= 0.5 * (s + e) <= re_]
        key = (int(level), int(batch))
        n, t = out.get(key, (0, 0.0))
        out[key] = (n + len(inside), t + sum(e - s for s, e in inside) * 1e-6)
    return out


def breakdown(run: RunData, top: int = 10) -> Optional[Dict[str, list]]:
    """The device operations that took most time, and the idle gaps of the
    profiled window summed by the innermost span the host was in."""
    win = run.profiled_window()
    if win is None or not run.kernels:
        return None
    by_op: Dict[str, float] = {}
    for n, s, e in run.kernels:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    # Merged busy intervals, then the gaps between them.
    merged: List[List[float]] = []
    for s, e in sorted((max(s, win[0]), min(e, win[1])) for _, s, e in run.kernels):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = []
    prev = win[0]
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if win[1] > prev:
        gaps.append((prev, win[1]))
    # Innermost range at each gap's midpoint: ranges nest (they are
    # synchronized spans), so the open range that started last is it.
    events = sorted([(s, 0, i) for i, (_, s, _e) in enumerate(run.ranges)]
                    + [(0.5 * (gs + ge), 1, j) for j, (gs, ge) in enumerate(gaps)])
    by_span: Dict[str, float] = {}
    open_ranges: List[int] = []
    for t, kind, i in events:
        if kind == 0:
            open_ranges.append(i)
            continue
        while open_ranges and run.ranges[open_ranges[-1]][2] < t:
            open_ranges.pop()
        inner = None
        for r in reversed(open_ranges):
            if run.ranges[r][2] >= t:
                inner = run.ranges[r][0]
                break
        key = inner[len("bench."):] if inner else "outside"
        gs, ge = gaps[i]
        by_span[key] = by_span.get(key, 0.0) + (ge - gs) * 1e-6
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def from_profiler(prof) -> Tuple[List[tuple], List[tuple], List[tuple]]:
    """(device operations, host bench ranges, device bench ranges) of a
    finished torch.profiler session. A `bench.*` range shows on both
    timelines: on the host as the span, on the device as the stretch of
    the operations launched inside it; the latter is no operation."""
    kernels, ranges, dev_ranges = [], [], []
    for e in prof.events():
        tr = e.time_range
        item = (e.name, float(tr.start), float(tr.end))
        if e.device_type.name == "CUDA":
            (dev_ranges if e.name.startswith("bench.") else kernels).append(item)
        elif e.name.startswith("bench."):
            ranges.append(item)
    return kernels, ranges, dev_ranges
