#!/usr/bin/env python3
"""The readings the limits of benchmark/limits/ are set from: one cell's
compared numbers over many seeds, in one process on one build of the
problem, each run judged against the cell's limits as a benchmark run is.

    python3 benchmark/control.py --workload NAME --seconds S \
        program:1,2,3 tf32:4,5,6 bf16:7,8,9 half:10,11 stale:12 altered:13

Modes:

* program: the program as it runs;
* tf32: the control of the float32 configuration, the program with its
  TF32 path switched on (`torch.backends.cuda.matmul.allow_tf32`): it
  reaches the SPDE field's matmuls;
* bf16: the control that reaches the Darcy solve, which has no matmul for
  TF32 to change: the kind's check with `control` on, where the
  reference's own CG with its values in bfloat16 (`verify.solver_for`)
  stands in the program's place for the checked samples;
* stale, half, altered: the faults of benchmark/faults.py, planted by the
  kind where its answers are produced (altered: 5 %).

Each run drives the cell's mix for S seconds at the cell's own sizes, then
makes the check of a benchmark run, and prints one JSON line: mode, seed,
the compared numbers, `correct` by the cell's limits, the checked samples
and the check's seconds. The benchmark's own runs never switch a control
or a fault on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402

MODES = ("program", "tf32", "bf16", "stale", "half", "altered")


def parse_runs(items):
    runs = []
    for item in items:
        mode, _, seeds = item.partition(":")
        if mode not in MODES:
            raise SystemExit(f"control: unknown mode {mode!r}")
        runs += [(mode, int(s)) for s in seeds.split(",") if s]
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("runs", nargs="+", help="mode:seed,seed,...")
    args = ap.parse_args(argv)
    runs = parse_runs(args.runs)
    import torch

    import drive
    import faults
    import verify

    if not torch.cuda.is_available():
        sys.exit("control: needs a CUDA card")
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    limits = harness.load_json(os.path.join(HERE, "limits", args.workload + ".json"))
    check_spec = spec["traffic"]["check"]
    dev = torch.device("cuda:0")
    kind = harness.load_kind(spec["traffic"]["kind"])
    built = kind.build(spec["config"], spec["traffic"], dev)
    state = {"mode": "program"}
    kind.plant(built["problem"],
               lambda: state["mode"] if state["mode"] in faults.FAULTS else None)
    rec = drive.Recorder(False, dev)
    kind.instrument(rec, built)
    ref = kind.reference(spec["config"], built["kinv"])
    for n, (mode, seed) in enumerate(runs):
        state["mode"] = mode
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        torch.backends.cudnn.allow_tf32 = mode == "tf32"
        rec.clear()
        traffic = kind.Traffic(built, spec["traffic"], seed, rec)
        rec.keep_fields = kind.field_ordinals(check_spec, seed)
        if n == 0:
            traffic.warm()
        drive.run_window(traffic, args.seconds)
        t0 = time.perf_counter()
        res = kind.check(spec["config"], built["kinv"], rec, kind.keep(traffic), check_spec,
                         device=dev, ref=ref, control=mode == "bf16")
        correct, _ = verify.judge(res["numbers"], limits)
        print(json.dumps({"mode": mode, "seed": seed, "numbers": res["numbers"],
                          "correct": correct, "checked": res["checked"],
                          "failed": res["failed"], "attempted": res["attempted"],
                          "check_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
