"""The metric readers' arithmetic on synthetic runs."""

import numpy as np
import pytest

import harness
import tracedata
from tracedata import RunData


def reader(name):
    return harness.load_reader(name)


def test_rate_is_whole_window_over_all_work():
    # Three batches of 8 with a 1 s stall between the second and third:
    # the rate counts the stall.
    run = RunData(units=[(0.0, 0.5, 8), (0.5, 1.0, 8), (2.0, 2.5, 8)])
    assert reader("samples_per_s")(run) == pytest.approx(24 / 2.5)


def test_batch_p90_over_all_batches():
    walls = [0.1] * 18 + [0.5, 0.9]
    t = 0.0
    units = []
    for w in walls:
        units.append((t, t + w, 8))
        t += w
    run = RunData(units=units)
    assert reader("batch_ms_p90")(run) == pytest.approx(np.percentile(np.array(walls) * 1e3, 90))
    assert reader("batch_ms_p90")(run) > 100.0  # the stalls reach the tail


def test_idle_from_overlapping_kernels():
    # Window 0..100 us; kernels 10-30 and 20-40 overlap (busy 30), 60-70.
    run = RunData(kernels=[("a", 10.0, 30.0), ("b", 20.0, 40.0), ("c", 60.0, 70.0)],
                  ranges=[("bench.unit", 0.0, 100.0)])
    busy, window = tracedata.busy_idle(run)
    assert busy == pytest.approx(40e-6) and window == pytest.approx(100e-6)
    assert reader("idle_pct.rate")(run) == pytest.approx(60.0)
    gaps = dict(tracedata.breakdown(run)["idle_gaps"])
    assert gaps["unit"] == pytest.approx(60e-6)


def test_k1_bytes_at_a_small_shape():
    # 2 x 3 x 4 cells, 3 axes; 30 free faces; batch 5; float32.
    lvl = dict(n_s=24, n_u_active=30, d=3)
    assert tracedata.k1_apply_bytes(lvl, 5, 4) == 4 * (2 * 5 * 30 + 5 * 24 + 3 * 3 * 24)
    # Six K1 launches (two applies) in a 10 us solve range, 1 us each.
    kernels = [("line_solve_kernel<float>", 1.0 + i, 2.0 + i) for i in range(6)]
    run = RunData(kernels=kernels, dev_ranges=[("bench.solve.L0.b5", 0.0, 10.0)], levels=[lvl])
    need = 2 * tracedata.k1_apply_bytes(lvl, 5, 4)
    expect = 100.0 * need / tracedata.peaks()["hbm_bytes_per_s"] / 6e-6
    assert reader("k1_roofline")(run) == pytest.approx(expect)


def test_readers_without_a_trace_return_nothing():
    run = RunData(units=[(0.0, 1.0, 8)])
    for name in ("idle_pct.rate", "k1_roofline", "launches_per_iter.rate", "sampler_ms.rate"):
        assert reader(name)(run) is None


def test_layer_spans_per_batch():
    spans = [("unit", 0.0, 1.0, 0, 0), ("sampler", 0.1, 0.2, 1, 0), ("darcy", 0.2, 0.6, 1, 0),
             ("solve.L1", 0.2, 0.3, 2, 0), ("sampler", 0.6, 0.7, 1, 0),
             ("darcy", 0.7, 0.9, 1, 0)]
    calls = [dict(unit=0), dict(unit=0)]
    run = RunData(spans=spans, calls=calls)
    assert reader("sampler_ms.rate")(run) == pytest.approx(1e3 * 0.2 / 2)
    assert reader("darcy_ms.rate")(run) == pytest.approx(1e3 * 0.6 / 2)
