"""BENCHMARK.json against the benchmark contract: keys, names, units,
files, and which metric each cell reports."""

import json
import os
import re

import pytest

import harness

B = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16 and 1 <= len(B["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.startswith("/")
               and ".." not in p.split("/") for p in B["paths"])
    assert all(LINE(w) for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # A full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell
    # to compile, 1200 s spare, within 43200 s at 24 cells.
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE(c["source"]) and LINE(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(B["paths"][0] + "/")
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE(w["why"])
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for e in B["configs"] + B["workloads"] + B["end_to_end"] + B["per_layer"]:
        assert e["name"] not in seen
        seen.add(e["name"])
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE(m["layer"])
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_has_its_files_and_metrics(cell):
    spec = harness.cell_spec(B, cell)
    kind = spec["traffic"]["kind"]
    assert os.path.exists(os.path.join(harness.HERE, "kinds", kind + ".py"))
    mod = harness.load_kind(kind)  # raises where an export is missing
    assert all(callable(getattr(mod, e)) for e in harness.KIND_EXPORTS)
    assert os.path.exists(os.path.join(harness.HERE, "limits", cell + ".json"))
    e2e = [m["name"] for m in harness.cell_metrics(B, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.cell_metrics(B, cell, True)
    assert per
    for m in per:
        assert m["moves"] in e2e  # a per-layer metric moves one its cell reports
    for m in harness.cell_metrics(B, cell, False) + per:
        assert callable(harness.load_reader(m["name"]))


def test_roofline_names_and_layers():
    layers = {}
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "kernel K1 (csrc/thomas.cu)" in layers
