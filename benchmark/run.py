#!/usr/bin/env python3
"""One run of one benchmark cell of parelagmc_tpu_torch on this machine's
CUDA card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell, its configuration and its traffic
mix come from BENCHMARK.json and the files it names under benchmark/; the
mix's `kind` names the module under benchmark/kinds/ that drives it. The
run builds the problem through the port's `build_problem`, warms every
shape the mix uses (set-up), runs the mix for S seconds, then checks a
sample of what the window produced against the plain reference (the
kind's `check`). Untraced it prints the cell's end-to-end metrics,
traced (`--trace 1`: synchronized spans, torch.profiler over the first
units) its per-layer metrics. Standard error ends with each compared
number beside its limit; the last line of standard output is one JSON
object. Exits non-zero without a card, and if a module of JAX or of the
JAX package is loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_of(torch, chips: int, need_card: bool):
    if not need_card:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.exit(f"benchmark: the cell needs {chips} CUDA card(s); this machine has {n}")
    return torch.device("cuda:0")


def main(argv=None, need_card: bool = True, patch=None) -> int:
    """One run. `need_card=False` runs on the CPU (the harness's tests);
    `patch(kind, built)` may replace parts of the built program (its fault
    tests)."""
    args = parse(argv)
    age = harness.process_age()
    t_proc0 = time.perf_counter() - age if age is not None else _T_IMPORT
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, args.workload)
    cell, config, traffic_spec = spec["cell"], spec["config"], spec["traffic"]
    limits = harness.load_json(os.path.join(HERE, "limits", args.workload + ".json"))

    import numpy as np
    import torch

    import drive
    import tracedata
    import verify

    dev = device_of(torch, int(cell["chips"]), need_card)
    kind = harness.load_kind(traffic_spec["kind"])
    built = kind.build(config, traffic_spec, dev)
    if patch is not None:
        patch(kind, built)
    rec = drive.Recorder(bool(args.trace), dev)
    kind.instrument(rec, built)
    traffic = kind.Traffic(built, traffic_spec, args.seed, rec)
    rec.keep_fields = kind.field_ordinals(traffic_spec["check"], args.seed)
    traffic.warm()
    drive.sync(dev)
    setup_s = time.perf_counter() - t_proc0

    profile_units = int(traffic_spec.get("profile_units", 1)) if args.trace else 0
    win = drive.run_window(traffic, args.seconds, profile_units)
    drive.sync(dev)
    memory_peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0

    kernels, ranges, dev_ranges = [], [], []
    if win["profiler"] is not None:
        kernels, ranges, dev_ranges = tracedata.from_profiler(win["profiler"])
    levels = [dict(n_s=lvl.n_s, n_u_active=int(np.sum(~lvl.ess_faces(
                  np.asarray(built["config"].ess_attr)))), d=lvl.dim)
              for lvl in built["problem"].hierarchy.levels]
    run = tracedata.RunData(
        setup_s=setup_s, units=win["units"], spans=rec.spans, solves=rec.solves,
        calls=rec.calls, kernels=kernels, ranges=ranges, dev_ranges=dev_ranges,
        profile_units=win["profile_units"], levels=levels,
        dtype_bytes=torch.finfo(built["problem"].dtype).bits // 8)

    metrics = {}
    for m in harness.cell_metrics(bench, args.workload, bool(args.trace)):
        value = harness.load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    breakdown = None
    if args.trace:
        bi = tracedata.busy_idle(run)
        device["busy_s"], device["window_s"] = bi if bi else (0.0, 0.0)
        breakdown = tracedata.breakdown(run)
        print(f"# traced: {len(kernels)} device operations in {win['profile_units']} units; "
              f"K1 launches and seconds per (level, batch) {tracedata.k1_by_solve(run)}",
              file=sys.stderr)

    # The program's state goes before the reference runs.
    kept = kind.keep(traffic)
    kinv = built["kinv"]
    del traffic, built
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    res = kind.check(config, kinv, rec, kept, traffic_spec["check"], device=dev)
    correct, checks = verify.judge(res["numbers"], limits)
    print(f"# check: {time.perf_counter() - t_check:.1f} s, samples checked "
          f"{res['checked']}, power {harness.power_limit()}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    found = harness.forbidden_loaded()
    if found:
        print("benchmark: JAX or the JAX package is loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(harness.result_line(correct, res["attempted"], res["failed"], metrics, device,
                              checks, breakdown))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
