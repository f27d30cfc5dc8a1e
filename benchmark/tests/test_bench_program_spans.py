"""The readers of the program's spans on a synthetic traced run, and a
traced run of the CPU test cell that test_bench_cells.py builds."""

import json
import sys

import pytest

import harness
import programspans
from parelagmc_tpu_torch.utils import trace
from test_bench_cells import copy, run_cell  # noqa: F401  (copy: the fixture)
from tracedata import RunData

NEW = ("host_syncs_per_batch.rate", "idle_in_krylov_pct.rate")
T0 = 10.0  # the profiled unit's start on the host clock, s


def _span(name, index, parent, a_us, b_us, **attrs):
    s = trace.Span(name, index, parent, (0, 1), attrs)
    s.t0, s.t1 = int((T0 + a_us * 1e-6) * 1e9), int((T0 + b_us * 1e-6) * 1e9)
    return s


# One batch on host us 10-990 of a unit at host T0..T0 + 1 ms, profiled as
# bench.unit 5000-6000 us: the first residual's apply, then two iterations,
# the second waiting 100 us.
SPANS = [
    _span("mlmc.batch", 0, -1, 10, 990,
          counters={"krylov.iterations": 2, "host_syncs.krylov_test": 3,
                    "host_syncs.manager_copy": 1, "kernel.thomas": 6}),
    _span("darcy.solve", 1, 0, 100, 900, level=1),
    _span("darcy.setup", 2, 1, 100, 200, level=1),
    _span("krylov.pcg", 3, 1, 200, 880, level=1),
    _span("krylov.apply", 4, 3, 200, 205, level=1),
    _span("krylov.iter", 5, 3, 300, 500, level=1),
    _span("krylov.apply", 6, 5, 300, 350, level=1),
    _span("wait.krylov_test", 7, 5, 450, 500, level=1),
    _span("krylov.iter", 8, 3, 500, 800, level=1),
    _span("wait.krylov_test", 9, 8, 700, 800, level=1),
    _span("wait.manager_copy", 10, 0, 950, 980),
    _span("mlmc.batch", 11, -1, 5000, 6000),  # outside the profiled unit
]
# Busy 0-100, 320-340, 460-700, 880-1000: idle 220 in krylov.pcg (midpoint
# 210, after its first apply), 120 in a krylov.iter (after its apply), 180
# in a wait.krylov_test.
KERNELS = [("k", 5000.0 + a, 5000.0 + b) for a, b in ((0, 100), (320, 340), (460, 700),
                                                      (880, 1000))]
@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    return RunData(spans=[("unit", T0, T0 + 1e-3, 0, 0)], units=[(T0, T0 + 1e-3, 8)],
                   ranges=[("bench.unit", 5000.0, 6000.0)], kernels=KERNELS,
                   solves=[(0, 1, 2, 0)], profile_units=1)


def test_the_readers_on_a_synthetic_run(run):
    want = {"host_syncs_per_batch.rate": 4.0,
            "idle_in_krylov_pct.rate": 100.0 * 120 / 520}
    for name, value in want.items():
        assert harness.load_reader(name)(run) == pytest.approx(value), name


def test_an_apply_outside_an_iteration_is_not_the_loops_idle(run, monkeypatch):
    """Whether a gap is the loop's is read from the span's ancestors, not
    its name: the same gap under the first residual's apply (outside any
    krylov.iter) is not the loop's, under an iteration's apply it is."""
    spans = list(SPANS)
    spans[4] = _span("krylov.apply", 4, 3, 200, 280, level=1)  # now holds midpoint 210
    monkeypatch.setattr(trace, "spans", lambda: spans)
    assert programspans.idle_by_program_span(run)["krylov.apply"] == pytest.approx(220e-6)
    assert programspans.idle_in_krylov_pct(run) == pytest.approx(100.0 * 120 / 520)
    spans[4] = _span("krylov.apply", 4, 5, 200, 280, level=1)  # as if inside an iteration
    assert programspans.idle_in_krylov_pct(run) == pytest.approx(100.0 * 340 / 520)


def test_idle_by_program_span_sums_to_the_idle_time(run):
    idle = programspans.idle_by_program_span(run)
    assert list(idle) == ["krylov.pcg", "wait.krylov_test", "krylov.iter"]
    assert idle["krylov.pcg"] == pytest.approx(220e-6)
    rep = programspans.report(run)
    assert rep["idle_sum_s"] == pytest.approx(rep["window_minus_busy_s"])
    assert rep["krylov_iterations_program_recorder"] == (2, 2)


def test_the_readers_read_nothing_without_the_tracer(run, monkeypatch):
    """On a program without utils/trace.py (the parent of this reader), and
    untraced, every reader returns None and none raises."""
    monkeypatch.setitem(sys.modules, "parelagmc_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["parelagmc_tpu_torch.utils"], "trace")
    assert all(harness.load_reader(n)(run) is None for n in NEW)
    monkeypatch.undo()
    untraced = RunData(units=[(T0, T0 + 1e-3, 8)])
    assert all(harness.load_reader(n)(untraced) is None for n in NEW)


def test_a_traced_run_of_the_test_cell_reads_the_program(copy):  # noqa: F811
    res, err = run_cell(copy, "none", "tiny-pair", 2 ** 31 + 5, trace=1)
    assert res["correct"]
    # No device operations on the CPU: the idle share has nothing to read.
    assert res["metrics"]["host_syncs_per_batch.rate"]["value"] > 0
    assert "idle_in_krylov_pct.rate" not in res["metrics"]
    line = [l for l in err.splitlines() if l.startswith("# program spans: ")][-1]
    program, recorder = json.loads(line.split(": ", 1)[1])["krylov_iterations_program_recorder"]
    assert program == recorder > 0
