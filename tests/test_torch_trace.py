"""The port's tracer (parelagmc_tpu_torch/utils/trace.py) on the CPU: off
it records nothing and never enters record_function; on (under
torch.profiler) the level step's spans nest under one batch, the Krylov
counters match the solvers' SolveInfo, the buffer is bounded, and
benchmark/programspans.py puts the spans on the profiler's clock."""

import dataclasses
import os
import re
import sys
import time

import pytest
import torch

from _torch_parity import CPU
from parelagmc_tpu_torch import kernels
from parelagmc_tpu_torch.config import ProblemConfig, SolverConfig
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.ops.solvers import minres, pcg
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MLMCManager
from parelagmc_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "parelagmc_tpu_torch")


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spd(n=24, batch=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(n, n, generator=g, dtype=torch.float64)
    a = m @ m.T + n * torch.eye(n, dtype=torch.float64)
    return (lambda x: x @ a), torch.randn(batch, n, generator=g, dtype=torch.float64)


@pytest.fixture(scope="module")
def problem():
    """An 8^3 / 4^3 box hierarchy under the SPE10 cells' solver: coefMG with
    a bf16 Chebyshev V-cycle over several grid levels, adjoint QoI,
    mean-field x0."""
    solver = SolverConfig(name="cg-schur-coefmg", max_iterations=75, relative_tolerance=1e-4,
                          adjoint_qoi=True, coefmg_cheby_order=3,
                          coefmg_prec_dtype="bfloat16", meanfield_x0=True,
                          coarse_dense_cutoff=4)
    cfg = ProblemConfig(mesh="box", ncells=(4, 4, 4), lengths=(2.0, 2.0, 2.0), refinements=1,
                        sampler_name="pde", correlation_length=0.3, variance=1.0,
                        lognormal=True, qoi="eff_perm", ess_attr=(0, 1, 1, 1, 1, 0),
                        obs_attr=(1, 0, 0, 0, 0, 0), inflow_attr=(0, 0, 0, 0, 0, 1),
                        batch_size=8, dtype="float32", cost_model="dofs", output_filename="",
                        darcy_solver=solver)
    prob = build_problem(cfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    mgr.init_run([8, 0])  # the mean-field starts, built at first use
    return prob, mgr


def _no_record_function(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the port entered record_function")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)


def test_off_a_solve_records_nothing_and_never_enters_record_function(monkeypatch):
    _no_record_function(monkeypatch)
    apply_a, b = _spd()
    assert not (trace.BATCH_TRACE or torch.autograd.profiler._is_profiler_enabled)
    trace.reset()
    syncs = trace.counters("host_syncs").get("krylov_test", 0)
    x, info = pcg(apply_a, b, rtol=1e-10)
    assert trace.spans() == [] and info.iterations > 0
    # The counters are on all the same: one continue test a trip, plus the first.
    assert trace.counters("host_syncs")["krylov_test"] - syncs == info.iterations + 1
    assert trace.span("a", level=1) is trace.span("b") is trace.wait("c")
    with _profiled():
        pcg(apply_a, b, rtol=1e-10)  # on: spans, and still no record_function
    assert {s.name for s in trace.spans()} >= {"krylov.pcg", "krylov.iter", "krylov.apply",
                                               "krylov.prec", "wait.krylov_test"}


def test_nothing_in_the_port_enters_record_function():
    hits = []
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and re.search(r"record_function\s*\(",
                                               open(os.path.join(d, f)).read()):
                hits.append(os.path.join(d, f))
    assert hits == []


def test_spans_nest_under_one_batch(problem):
    prob, mgr = problem
    trace.reset()
    with _profiled():
        mgr.init_run([8, 0])
    spans = trace.spans()
    by = {s.index: s for s in spans}
    (batch,) = [s for s in spans if s.name == "mlmc.batch"]
    assert batch.parent == -1 and batch.batch == (0, mgr._counter)
    assert all(s.batch == batch.batch and s.t0 <= s.t1 for s in spans)
    iters = [s for s in spans if s.name == "krylov.iter"]
    assert iters
    for it in iters:
        pcg_span = by[it.parent]
        solve = by[pcg_span.parent]
        assert (pcg_span.name, solve.name, by[solve.parent].name) == (
            "krylov.pcg", "darcy.solve", "mlmc.batch")
        assert batch.t0 <= solve.t0 <= pcg_span.t0 <= it.t0 <= it.t1 <= pcg_span.t1 <= solve.t1
    solves = [s for s in spans if s.name == "darcy.solve"]
    assert [(s.attrs["level"], s.attrs["start"]) for s in solves] == [(1, "mean-field"),
                                                                       (0, "warm")]
    assert {s.attrs["role"] for s in spans if s.name == "krylov.pcg"} == {"primal", "adjoint"}
    assert sum(s.name == "darcy.setup" for s in spans) == 2
    # The V-cycle's grid levels nest through its recursion.
    grids = [s for s in spans if s.name == "coefmg.level"]
    assert {s.attrs["grid"] for s in grids} >= {0, 1}
    for s in grids:
        parent = by[s.parent]
        if s.attrs["grid"] == 0:
            assert parent.name == "krylov.prec"
        else:
            assert (parent.name, parent.attrs["grid"]) == ("coefmg.level", s.attrs["grid"] - 1)
    # The waits of the step and the copy sit directly under the batch.
    waits = {s.name for s in spans if s.parent == batch.index and s.name.startswith("wait.")}
    assert waits == {"wait.manager_sync", "wait.manager_copy"}


def test_krylov_iterations_match_the_solvers_info(problem):
    prob, mgr = problem
    solver, sampler = prob.solver, prob.sampler
    xi = sampler.sample(0, PRNGKey(7), 8)
    s_f, s_c = sampler.eval(0, xi), sampler.eval(1, xi, xi_level=0)
    n0 = trace.counters("krylov")["iterations"]
    _, _, info_f, info_c = solver.solve_fwd_pair(0, s_f, s_c)
    assert trace.counters("krylov")["iterations"] - n0 == info_f.iterations + info_c.iterations
    # The batch span's delta against the manager's iteration sums (per
    # sample: the pair's iterations broadcast over the batch).
    trace.reset()
    before = mgr._iter_sums[0]
    with _profiled():
        mgr.init_run([8, 0])
    (batch,) = [s for s in trace.spans() if s.name == "mlmc.batch"]
    delta = batch.attrs["counters"]
    assert delta["krylov.iterations"] * 8 == mgr._iter_sums[0] - before
    pcgs = [s for s in trace.spans() if s.name == "krylov.pcg"]
    assert sum(s.attrs["iterations"] for s in pcgs) == delta["krylov.iterations"]
    assert delta["host_syncs.krylov_test"] == delta["krylov.iterations"] + len(pcgs)


def test_minres_continue_test_is_a_counted_wait():
    apply_a, b = _spd(seed=1)
    n0 = trace.counters("host_syncs").get("krylov_test", 0)
    it0 = trace.counters("krylov")["iterations"]
    x, info = minres(apply_a, b, rtol=1e-8)
    assert trace.counters("krylov")["iterations"] - it0 == info.iterations
    assert trace.counters("host_syncs")["krylov_test"] - n0 >= info.iterations


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    trace.reset()
    with _profiled():
        for _ in range(trace.CAPACITY + 10):
            with trace.span("x"):
                pass
    spans = trace.spans()
    assert len(spans) == trace.CAPACITY
    assert trace.counter_values()["trace.dropped"] == 10
    assert spans[0].index + trace.CAPACITY - 1 == spans[-1].index  # the oldest went
    trace.reset()
    assert trace.spans() == [] and trace.counters("trace")["dropped"] == 0


def test_launch_counts_are_the_tracers_kernel_counters():
    assert kernels.launch_counts is trace.counters("kernel")
    assert {"kernel.thomas", "kernel.threefry_normal",
            "kernel.threefry_uniform"} <= set(trace.counter_values())


def test_a_span_lands_on_its_profiler_range():
    """Program spans inside `bench.unit` ranges (Recorder-style units: the
    range, then the host clock) map inside them, and within 100 us of them
    once benchmark/programspans.py puts them on the profiler's clock (the
    best of five units: a loaded host can stretch any one range's exit)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import programspans
        import tracedata
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmark"))
    trace.reset()
    units = []
    with _profiled() as prof:
        with torch.profiler.record_function("bench.warm"):  # the first range opens slowly
            pass
        for k in range(5):
            with torch.profiler.record_function("bench.unit"):
                t0 = time.perf_counter()
                with trace.span("probe"):
                    time.sleep(0.005)
                units.append(("unit", t0, time.perf_counter(), 0, k))
    _, ranges, _ = tracedata.from_profiler(prof)
    run = tracedata.RunData(spans=units, ranges=ranges, profile_units=5)
    probes = programspans.program_spans(run)
    unit_ranges = sorted(r[1:] for r in ranges if r[0] == "bench.unit")
    assert len(probes) == len(unit_ranges) == 5
    for probe, (start, end) in zip(probes, unit_ranges):
        assert start <= probe.start < probe.end <= end
        assert probe.end - probe.start >= 5e3  # the sleep, on the host's clock
    assert min(max(p.start - s, e - p.end) for p, (s, e) in zip(probes, unit_ranges)) < 100


def test_batch_trace_line_carries_the_batch_spans_totals(problem, monkeypatch, capsys):
    """PARELAGMC_BATCH_TRACE (read once at import; set here on the module)
    records spans without a profiler and prints the batch's line."""
    prob, mgr = problem
    monkeypatch.setattr(trace, "BATCH_TRACE", True)
    trace.reset()
    mgr.init_run([8, 0])
    (line,) = [l for l in capsys.readouterr().err.splitlines() if l.startswith("# batch-trace")]
    fields = dict(f.split("=", 1) for f in line.split()[3:])
    assert {"dt", "iters", "t", "setup_ms", "krylov_ms", "wait_ms", "host_syncs",
            "restarts"} == set(fields)
    (batch,) = [s for s in trace.spans() if s.name == "mlmc.batch"]
    totals = trace.batch_totals(batch)
    assert int(fields["host_syncs"]) == totals["host_syncs"] > 0
    assert 0 < float(fields["setup_ms"]) < float(fields["krylov_ms"]) < (
        (batch.t1 - batch.t0) * 1e-6)


def test_batch_trace_line_counts_the_krylov_restarts(problem, monkeypatch, capsys):
    """With a restart every second iteration, the line's `restarts` is the
    batch's `krylov.restarts` delta: one per two iterations of each PCG."""
    prob, mgr = problem
    monkeypatch.setattr(trace, "BATCH_TRACE", True)
    monkeypatch.setattr(prob.solver, "solver_cfg",
                        dataclasses.replace(prob.solver.solver_cfg, restart_every=2))
    trace.reset()
    mgr.init_run([8, 0])
    (line,) = [l for l in capsys.readouterr().err.splitlines() if l.startswith("# batch-trace")]
    fields = dict(f.split("=", 1) for f in line.split()[3:])
    (batch,) = [s for s in trace.spans() if s.name == "mlmc.batch"]
    pcgs = [s for s in trace.spans() if s.name == "krylov.pcg"]
    want = sum(s.attrs["iterations"] // 2 for s in pcgs)
    assert int(fields["restarts"]) == batch.attrs["counters"]["krylov.restarts"] == want > 0
