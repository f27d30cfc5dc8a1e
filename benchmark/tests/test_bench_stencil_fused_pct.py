"""The reader of `stencil_fused_pct.rate` on synthetic traced runs: the
share of the V-cycle's passes that ran as fused kernels, from the counters'
change over the profiled batches; 0 where every pass ran as a plain twin,
None without a profiled batch or without the counters (a program without
the fused passes)."""

import pytest

import harness
from parelagmc_tpu_torch.utils import trace
from tracedata import RunData

T0 = 10.0  # the profiled unit's start on the host clock, s


def _batch(index, a_us, b_us, **counters):
    s = trace.Span("mlmc.batch", index, -1, (0, index), {"counters": counters})
    s.t0, s.t1 = int((T0 + a_us * 1e-6) * 1e9), int((T0 + b_us * 1e-6) * 1e9)
    return s


def _run(monkeypatch, spans):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return RunData(spans=[("unit", T0, T0 + 1e-3, 0, 0)], units=[(T0, T0 + 1e-3, 8)],
                   ranges=[("bench.unit", 5000.0, 6000.0)], kernels=[("k", 5000.0, 5100.0)],
                   solves=[(0, 1, 2, 0)], profile_units=1)


READ = harness.load_reader("stencil_fused_pct.rate")
FUSED = {"kernel.coefmg_smooth": 600, "kernel.coefmg_restrict": 90,
         "kernel.coefmg_prolong": 90, "kernel.thomas": 93, "coefmg.graph_replays": 30}


@pytest.mark.parametrize("batches,want", [
    ([FUSED], 100.0),
    ([FUSED, {"kernel.coefmg_smooth": 20, "coefmg.eager_passes": 60}], 100.0 * 800 / 860),
    ([{"coefmg.eager_passes": 240, "coefmg.eager_cycles": 8}], 0.0),
    ([{"kernel.thomas": 93, "coefmg.graph_replays": 30}], None),  # without the fused passes
    ([], None),  # no batch
])
def test_the_share_of_fused_passes(monkeypatch, batches, want):
    spans = [_batch(i, 10 + 400 * i, 300 + 400 * i, **c) for i, c in enumerate(batches)]
    # A batch outside the profiled unit counts for nothing.
    spans.append(_batch(len(batches), 5000, 6000, **{"coefmg.eager_passes": 99}))
    got = READ(_run(monkeypatch, spans))
    assert got == (pytest.approx(want) if want is not None else None)


def test_an_untraced_run_reads_nothing(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [_batch(0, 10, 300, **FUSED)])
    assert READ(RunData(units=[(T0, T0 + 1e-3, 8)])) is None
