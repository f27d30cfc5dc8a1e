"""What the benchmark reads by name, and what it prints.

`BENCHMARK.json` (at the root of the checkout) names the cells; a cell's
configuration is `benchmark/configs/<config>.json`, its traffic mix
`benchmark/traffic/<traffic>.json`, its limits `benchmark/limits/<cell>.json`,
every metric a reader `benchmark/metrics/<metric>.py` with
`read(run) -> float | None`, and the `kind` a mix names a module
`benchmark/kinds/<kind>.py` with the exports of `KIND_EXPORTS`. A later
cell, mix, kind or metric is a new file and a new entry; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that may not be loaded in a run (compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "parelagmc_tpu")
# What the module of a traffic kind (benchmark/kinds/<kind>.py) exports:
# build(config, mix, device) -> {"config", "problem" (the port's build_problem
#     result), "kinv"};
# instrument(recorder, built): the port's methods the drive.Recorder wraps;
# Traffic(built, mix, seed, recorder): warm(), unit(k) -> samples completed;
# field_ordinals(check, seed): the noise draws whose fields are kept;
# keep(traffic) -> what the check needs of the program's state, taken
#     before that state is released;
# plant(problem, fault, rel): faults.FAULTS where the kind's answers are made;
# reference(config, kinv): the plain reference, built once;
# check(config, kinv, recorder, kept, check, device, ref=None, control=False)
#     -> {"numbers", "attempted", "failed", "checked"}; with `control`, the
#     control of benchmark/control.py stands in the program's place.
KIND_EXPORTS = ("build", "instrument", "Traffic", "field_ordinals", "keep", "plant",
                "reference", "check")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(bench: dict, workload: str, bench_dir: str = HERE) -> dict:
    """The cell, its configuration file and its traffic file."""
    cell = find(bench["workloads"], workload, "workload")
    config = find(bench["configs"], cell["config"], "config")
    return {
        "cell": cell,
        "config": load_json(os.path.join(os.path.dirname(bench_dir), config["file"])),
        "traffic": load_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")),
    }


def cell_metrics(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of the cell prints: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric with a `workloads`
    list belongs to those cells; one without it to every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_reader(name: str, bench_dir: str = HERE):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_kind(name: str, bench_dir: str = HERE):
    """The module benchmark/kinds/<name>.py of a traffic kind, checked for
    the exports of KIND_EXPORTS."""
    path = os.path.join(bench_dir, "kinds", name + ".py")
    if not os.path.exists(path):
        raise ValueError(f"unknown traffic kind {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location("kind_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [e for e in KIND_EXPORTS if not callable(getattr(mod, e, None))]
    if missing:
        raise ValueError(f"traffic kind {name!r} lacks {', '.join(missing)}")
    return mod


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (parelagmc_tpu_torch is not parelagmc_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


def process_age() -> Optional[float]:
    """Seconds since this process started, from /proc (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def power_limit() -> str:
    """`name, power.limit` of the first card as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, checks: Dict[str, list], breakdown: Optional[dict] = None) -> str:
    """The last line of a run: the keys of the contract, the compared
    numbers (each [value, limit]) last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
