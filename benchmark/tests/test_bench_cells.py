"""Whole runs on the CPU (the look for a card skipped), in a copy of the
benchmark to which test cells are added from new files alone, one of them
of a traffic kind of its own: each runs and is correct; the same run with
the timed path broken underneath (benchmark/faults.py, planted by the
kind) is not; the level-step kind reads what it read before it was a
module of its own; and the controls fail the SPE10 cells' limits."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import drive
import faults
import harness
import verify
from reference import problem as rp, threefry
from reference.mixed import Precision

DRIVER = """
import sys
sys.path.insert(0, 'benchmark')
import run

name = None if sys.argv[1] == 'none' else sys.argv[1]
patch = lambda kind, built: kind.plant(built["problem"], lambda: name, rel=1e-3)
sys.exit(run.main(sys.argv[2:], need_card=False, patch=patch))
"""

# A 4 x 4 x 4 box in two levels, float32, cg-schur: the test cell's
# configuration.
TINY = {
    "name": "tiny",
    "problem": {"mesh": "box", "ncells": [2, 2, 2], "lengths": [2.0, 2.0, 2.0],
                "refinements": 1, "sampler_name": "pde", "correlation_length": 0.1,
                "variance": 1.0, "lognormal": True, "qoi": "eff_perm",
                "ess_attr": [0, 1, 1, 1, 1, 0], "obs_attr": [1, 0, 0, 0, 0, 0],
                "inflow_attr": [0, 0, 0, 0, 0, 1], "batch_size": 8, "dtype": "float32",
                "cost_model": "dofs",
                "darcy_solver": {"name": "cg-schur", "max_iterations": 500,
                                 "relative_tolerance": 1e-06}},
    "reduced": [],
}


# A traffic kind of its own, as a later PR adds one: back-to-back batches
# of one level's cold solve with its pressure, keyed by a schedule of its
# own; its answer, its sum and its fault site are not the level step's.
PRESSURE_KIND = '''"""Traffic kind "pressure_steps" (`level`, `batch`): back-to-back batches
of one level's cold solve with its pressure, keyed
fold_in(fold_in(PRNGKey(seed + 101), level), counter). A sample's answer
is its normalised pressure integral, the mean of the cells' pressures on
a grid of equal cells; the traffic's own sum of the answers is what the
check holds the recorded answers to."""

import numpy as np

import drive
import faults
import verify
from reference import threefry
from reference.mixed import Precision
from reference.problem import ReferenceProblem

field_ordinals = verify.field_ordinals


def key_of(seed, level, counter):
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed + 101), level), counter)


def build(spec, traffic, device):
    return drive.build_problem(spec, device, batch_size=int(traffic["batch"]))


def instrument(rec, built):
    rec.wrap_sampler(built["problem"].sampler)

    def on_solve(args, kwargs, out):
        rec.on_solve(args, kwargs, out)
        if rec.depth == 0:
            rec.calls[-1]["answer"] = out[3].mean(-1)

    rec.wrap(built["problem"].solver, "solve_fwd", drive.solve_span, on_solve)


def plant(problem, fault, rel=0.05):
    faults.install(problem.solver, "solve_fwd", fault, index=3, rel=rel)


class Traffic:
    def __init__(self, built, traffic, seed, rec):
        self.prob, self.seed, self.rec = built["problem"], int(seed), rec
        self.level, self.batch = int(traffic["level"]), int(traffic["batch"])
        self.counter, self.total = 0, 0.0

    def _batch(self, seed, counter):
        sampler = self.prob.sampler
        xi = sampler.sample(self.level, key_of(seed, self.level, counter), self.batch)
        out = self.prob.solver.solve_fwd(self.level, sampler.eval(self.level, xi),
                                         return_pressure=True)
        return out[3].mean(-1)

    def warm(self):
        self.rec.active = False
        try:
            for counter in (1, 2):
                self._batch(self.seed + 2 ** 40, counter)
        finally:
            self.rec.active = True

    def unit(self, k):
        self.rec.unit = k
        self.counter += 1
        with self.rec.span("unit"):
            self.total += float(np.sum(verify.host(self._batch(self.seed, self.counter))))
        return self.batch


def keep(traffic):
    return {"seed": traffic.seed, "total": traffic.total}


def reference(spec, kinv):
    return ReferenceProblem(spec, kinv=kinv)


def check(spec, kinv, rec, kept, check_spec, device="cpu", ref=None, control=False):
    if control:
        raise ValueError("pressure_steps has no control")
    seed = kept["seed"]
    ref = ref or reference(spec, kinv)
    prec = Precision(device=device)
    batches = [dict(level=c["level"], key=k, q=verify.host(c["answer"]), iters=c["iters"],
                    conv=verify.host(c["conv"]).astype(bool),
                    schedule=key_of(seed, c["level"], i + 1))
               for i, (c, (_, _, k)) in enumerate(zip(rec.calls, rec.keys))]
    rng = np.random.default_rng(seed % 2 ** 63)
    picks = verify.choose(batches, int(check_spec["batches"]), int(check_spec["rows"]), rng)
    gaps = []
    for i, rows in picks:
        b = batches[i]
        w = ref.coefficients(b["schedule"], b["q"].size, rows, b["level"], b["level"], prec)
        # The reference's cell unknown is minus the physical pressure.
        want = -np.array([ref.darcy[b["level"]].solve(wi)[1].mean() for wi in w])
        gaps.append(np.abs(b["q"][rows] - want) / np.abs(want))
    answers = [b["q"] for b in batches]
    return {
        "numbers": {"p_mean_gap": float(np.mean(np.concatenate(gaps))),
                    "field_gap": verify.field_gap(rec, ref, int(check_spec["rows"]), seed,
                                                  prec),
                    "key_miss": int(sum(tuple(b["key"]) != b["schedule"] for b in batches)),
                    "sum_gap": verify.sum_gap(kept["total"], [float(np.sum(a)) for a in answers]),
                    "nonfinite": int(sum(np.sum(~np.isfinite(a)) for a in answers))},
        "attempted": int(sum(a.size for a in answers)),
        "failed": int(sum(np.sum(~b["conv"] | ~np.isfinite(b["q"])) for b in batches)),
        "checked": [(batches[i]["level"], len(rows)) for i, rows in picks],
    }
'''

# The files a test cell adds to the copy, under benchmark/; no other file
# of the copy differs from the source tree.
ADDED = {"configs/tiny.json", "traffic/tiny_pairs.json", "limits/tiny-pair.json",
         "metrics/batches_seen.py", "kinds/pressure_steps.py", "traffic/tiny_pressure.json",
         "limits/tiny-pressure.json"}
TEST_CELLS = ("tiny-pair", "tiny-pressure")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """The benchmark with test configurations, mixes, limits, a metric and
    a traffic kind added as new files, and new entries in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = harness.load_benchmark()
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (root / "benchmark" / "traffic" / "tiny_pairs.json").write_text(json.dumps(
        {"kind": "level_steps", "level": 0, "batch": 8, "profile_units": 2,
         "check": {"batches": 3, "rows": 4}}))
    limits = {"field_gap": 1e-5, "q_mean_gap": 1e-4, "key_miss": 0, "sum_gap": 1e-9,
              "nonfinite": 0}
    (root / "benchmark" / "limits" / "tiny-pair.json").write_text(json.dumps(limits))
    (root / "benchmark" / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(run.batches())\n")
    (root / "benchmark" / "kinds" / "pressure_steps.py").write_text(PRESSURE_KIND)
    (root / "benchmark" / "traffic" / "tiny_pressure.json").write_text(json.dumps(
        {"kind": "pressure_steps", "level": 0, "batch": 8, "profile_units": 2,
         "check": {"batches": 3, "rows": 4}}))
    (root / "benchmark" / "limits" / "tiny-pressure.json").write_text(json.dumps(
        {"field_gap": 1e-5, "p_mean_gap": 1e-5, "key_miss": 0, "sum_gap": 1e-9,
         "nonfinite": 0}))
    b["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-pair", "config": "tiny", "traffic": "tiny_pairs",
                           "chips": 1, "why": "t"})
    b["workloads"].append({"name": "tiny-pressure", "config": "tiny",
                           "traffic": "tiny_pressure", "chips": 1, "why": "t"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "spe10-l0-pair" in m.get("workloads", []):
            m["workloads"] += list(TEST_CELLS)
    b["per_layer"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                           "source": "program_counter", "layer": "manager (uq/managers)",
                           "moves": "samples_per_s", "workloads": ["tiny-pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "drive_cpu.py").write_text(DRIVER)
    return root


def tree_hashes(top) -> dict:
    """sha256 of every file under `top` (relative paths), tests and
    __pycache__ left out."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "tests")]
        for f in filenames:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def run_cell(root, fault, cell, seed, trace=0):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "drive_cpu.py", fault, "--workload", cell, "--seed",
                          str(seed), "--seconds", "1.5", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_added_cell_runs_and_is_correct(copy):
    res, err = run_cell(copy, "none", "tiny-pair", 2 ** 31 + 11)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"samples_per_s", "batch_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks" and "field_gap" in err.splitlines()[-5]
    assert 0.0 < res["checks"]["field_gap"][0] < 1e-5
    traced, _ = run_cell(copy, "none", "tiny-pair", 5, trace=1)
    assert traced["correct"] and traced["metrics"]["batches_seen"]["value"] > 0
    assert "darcy_ms.rate" in traced["metrics"] and "samples_per_s" not in traced["metrics"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(copy, fault):
    res, err = run_cell(copy, fault, "tiny-pair", 12345)
    assert res["correct"] is False, err[-2000:]


@pytest.mark.parametrize("fault", ("none",) + faults.FAULTS)
def test_a_new_kind_is_one_new_file(copy, fault):
    """A kind of its own, added as kinds/pressure_steps.py beside a mix,
    limits and entries: no file the benchmark had is edited (by hash, and
    BENCHMARK.json less the test entries), its cell runs and is correct,
    and each fault planted at its own site makes it not correct."""
    src, got = tree_hashes(harness.HERE), tree_hashes(copy / "benchmark")
    assert set(got) - set(src) == ADDED and set(src) <= set(got)
    assert all(got[f] == h for f, h in src.items())
    b = json.loads((copy / "BENCHMARK.json").read_text())
    b["configs"] = [c for c in b["configs"] if c["name"] != "tiny"]
    b["workloads"] = [w for w in b["workloads"] if w["name"] not in TEST_CELLS]
    b["per_layer"] = [m for m in b["per_layer"] if m["name"] != "batches_seen"]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in TEST_CELLS]
    assert b == harness.load_benchmark()
    res, err = run_cell(copy, fault, "tiny-pressure", 2 ** 31 + 23)
    if fault == "none":
        assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, err[-2000:]
        assert set(res["metrics"]) == {"samples_per_s", "batch_ms_p90", "setup_s"}
        assert 0.0 < res["checks"]["p_mean_gap"][0] < 1e-5
        assert 0.0 < res["checks"]["field_gap"][0] < 1e-5
    else:
        assert res["correct"] is False, err[-2000:]


# What the level-step kind read on the tiny cell before it was a module of
# its own (the harness of the parent tree, CPU): six units after the warm-up
# of a fresh recorder, then the check; keys as (unit, level, key), fields as
# the ordinals of the kept draws (fine and coarse each).
PINNED = {
    (0, 2 ** 31 + 11): {
        "numbers": {"field_gap": 7.249969783937716e-07, "q_mean_gap": 8.959367711534249e-07,
                    "q_gap": 2.9223628987199454e-06, "key_miss": 0, "sum_gap": 0.0,
                    "nonfinite": 0},
        "checked": [[0, 4], [0, 4], [0, 4]], "fields": [2, 2, 5, 5],
        "keys": [[0, 0, [4024384324, 3256013459]],
                 [1, 0, [571532971, 1606197824]],
                 [2, 0, [491308221, 1200060080]],
                 [3, 0, [922609948, 1644011379]],
                 [4, 0, [20635421, 3727078067]],
                 [5, 0, [2088689480, 2040102122]]]},
    (0, 12345): {
        "numbers": {"field_gap": 4.2149008529351136e-07, "q_mean_gap": 6.476074845829641e-07,
                    "q_gap": 2.245586980560584e-06, "key_miss": 0, "sum_gap": 0.0,
                    "nonfinite": 0},
        "checked": [[0, 4], [0, 4], [0, 4]], "fields": [1, 1, 5, 5],
        "keys": [[0, 0, [2055353764, 137581485]],
                 [1, 0, [3232863302, 2034309326]],
                 [2, 0, [3605859494, 1953058837]],
                 [3, 0, [1885643832, 4272108524]],
                 [4, 0, [3479472201, 783410881]],
                 [5, 0, [2255288098, 4212474324]]]},
    (1, 2 ** 33 + 7): {
        "numbers": {"field_gap": 1.1175993620994798e-07, "q_mean_gap": 5.760414313597818e-07,
                    "q_gap": 1.6648150568332423e-06, "key_miss": 0, "sum_gap": 0.0,
                    "nonfinite": 0},
        "checked": [[1, 4], [1, 4], [1, 4]], "fields": [2, 3],
        "keys": [[0, 1, [1716444293, 676656290]],
                 [1, 1, [629031813, 3099424982]],
                 [2, 1, [1991980664, 2425313412]],
                 [3, 1, [2908369458, 2035971453]],
                 [4, 1, [2460106279, 3349933328]],
                 [5, 1, [3306130566, 3098270155]]]},
}


@pytest.mark.parametrize("level,seed", list(PINNED))
def test_level_steps_reads_what_it_read(level, seed):
    """The tiny cell driven for six units (no timed window, whose batch
    count follows the clock) and checked: every compared number, the
    checked samples, the schedule's keys and the kept fields as the parent
    harness read them, exactly."""
    mix = {"kind": "level_steps", "level": level, "batch": 8, "check": {"batches": 3, "rows": 4}}
    kind = harness.load_kind("level_steps")
    built = kind.build(TINY, mix, "cpu")
    rec = drive.Recorder(False, "cpu")
    kind.instrument(rec, built)
    traffic = kind.Traffic(built, mix, seed, rec)
    rec.keep_fields = kind.field_ordinals(mix["check"], seed)
    traffic.warm()
    for k in range(6):
        traffic.unit(k)
    res = kind.check(TINY, built["kinv"], rec, kind.keep(traffic), mix["check"], device="cpu")
    want = PINNED[(level, seed)]
    assert res["numbers"] == want["numbers"]
    assert [list(c) for c in res["checked"]] == want["checked"]
    assert [[u, l, list(k)] for u, l, k in rec.keys] == want["keys"]
    assert sorted(o for o, *_ in rec.fields) == want["fields"]
    assert res["attempted"] == 48 and res["failed"] == 0


def test_the_controls_fail_the_cells_limits(monkeypatch):
    """The controls in the program's place, on a small SPE10-shaped grid:
    the reference in TF32 reads a field gap above every SPE10 cell's
    field_gap limit, and the reference's CG in bfloat16 a mean Q gap
    above every q_mean_gap limit."""
    cells = (10, 18, 7)
    monkeypatch.setattr(rp, "SPE10_CELLS", cells)
    spec = harness.load_json(os.path.join(harness.HERE, "configs", "spe10.json"))
    perm = dict(spec["permeability"], ncells=list(cells))
    ref = rp.ReferenceProblem(spec, kinv=drive.permeability({"permeability": perm}))
    limits = [harness.load_json(os.path.join(harness.HERE, "limits", w["name"] + ".json"))
              for w in harness.load_benchmark()["workloads"]]
    exact, bf16 = verify.solver_for("cpu"), verify.solver_for("cpu", storage="bfloat16")
    for seed in (1, 2, 3):
        field, q = [], []
        for level in (0, 1):
            key = threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), level), 1)
            for lv in (level, level + 1):
                w = ref.coefficients(key, 8, list(range(8)), level, lv, Precision())
                w_tf32 = ref.coefficients(key, 8, list(range(8)), level, lv, Precision("tf32"))
                field.append(np.max(np.abs(w_tf32 - w) / w))
                want = np.asarray(exact(ref.darcy[lv], w))
                q.append(np.abs(np.asarray(bf16(ref.darcy[lv], w)) - want) / np.abs(want))
        assert all(max(field) > lim["field_gap"] for lim in limits), field
        assert all(np.mean(np.concatenate(q)) > lim["q_mean_gap"] for lim in limits)
