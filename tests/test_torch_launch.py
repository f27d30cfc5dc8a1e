"""The port's drivers on several processes from their own command line:
`python -m torch.distributed.run --standalone` with gloo ranks on the CPU
(parallel/launch.init_from_env through the drivers' parse_args), float64.

* the golden MLMC at small width, 2 ranks, --sample-shards -1, fixed
  counts: its per-level sums against the in-process SampleMesh(2) run and
  the JAX package's 2-device run (2 of the virtual CPU devices of
  tests/conftest.py); the per-sample log and the checkpoint written once;
  resume on 2 ranks against the in-process resume;
* one decision: rank 1 is fed another cost reading, and both ranks still
  take the same N_l (the walltime cost is agreed over the ranks);
* the spatial driver with --spatial-shards 2 on 2 ranks (DistributedSlabs)
  against the stacked in-process run;
* the graft twin's dry run on 2 ranks in the distributed forms;
* no fallback: under torchrun's environment without a card the device
  raises, and a CUDA device gets NCCL.

Every launch has a deadline of its own and is killed past it (agent and
workers), so a desynchronized run fails instead of hanging.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config
from parelagmc_tpu.config import ProblemConfig as JaxProblemConfig
from parelagmc_tpu.parallel import SampleMesh as JaxSampleMesh
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
from parelagmc_tpu_torch.examples import spe10_mlmc
from parelagmc_tpu_torch.parallel import SampleMesh
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MLMCManager
from parelagmc_tpu_torch.utils.timing import TimeManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60  # seconds for one launch, torchrun's start-up included

# The golden problem at small width: the 4^3 box refined once (2 levels),
# float64, deep solves (the packages' rounding stays below 1e-9), batch 16.
GOLDEN_ARGV = ["--refinements", "1", "--dtype", "float64", "--batch", "16", "--samples", "16",
               "--variance", "0.25", "--seed", "5", "--mse", "2e-4",
               "--solver-opt", "relative_tolerance=1e-12", "--solver-opt", "max_iterations=400"]
FIXED = [32, 32]  # init_run counts of the fixed-count run: two batches a level


def _children(pid: int):
    """The pids whose parent is `pid` (torchrun detaches its workers from
    the agent's process group, so killing that group misses them)."""
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(entry))
            except (OSError, IndexError, ValueError):
                pass
    return kids


def torchrun(args, cwd, nproc: int = 2, deadline: int = DEADLINE):
    """Run `python -m torch.distributed.run --standalone` on `args` in
    `cwd`; (stdout, stderr). Past `deadline` the agent and its workers are
    killed and the launch fails."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", *args], cwd=str(cwd), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        for pid in [*_children(proc.pid), proc.pid]:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        out, err = proc.communicate()
        pytest.fail(f"launch killed past its deadline of {deadline} s:\n{err[-3000:]}")
    assert proc.returncode == 0, err[-6000:]
    return out, err


def rank_script(path, body: str) -> str:
    """Write a rank script (each rank's RANK in `rank`) and return its path."""
    with open(path, "w") as f:
        f.write("import json, os, sys\nrank = int(os.environ['RANK'])\n" + textwrap.dedent(body))
    return str(path)


def rank_results(cwd, n: int = 2):
    out = []
    for r in range(n):
        with open(os.path.join(cwd, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


_GOLDEN_RANKS = """
from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MLMCManager, managers

writes = []
savez = managers.np.savez
managers.np.savez = lambda *a, **k: (writes.append(a[0]), savez(*a, **k))
cfg, device = parse_args(sys.argv[1:], cost_model="dofs")
prob = build_problem(cfg, device=device)
mgr = MLMCManager(prob.solver, prob.sampler, cfg)
mgr.init_run({fixed})
sums, nsamples = mgr.sums.tolist(), mgr.level_nsamples.tolist()
mgr.save_state("state.npz")
mgr.close()
cfg.output_filename = ""
resumed = MLMCManager(prob.solver, prob.sampler, cfg)
est = resumed.resume("state.npz")
json.dump(dict(sums=sums, nsamples=nsamples, shards=mgr.sharding.n_devices,
               distributed=mgr.sharding.distributed, writes=writes, estimate=est,
               resumed_nsamples=resumed.level_nsamples.tolist()), open(f"rank{{rank}}.json", "w"))
"""


@pytest.fixture(scope="module")
def golden_ranks(tmp_path_factory):
    """The golden run on 2 gloo ranks (sample_shards -1, dofs cost):
    init_run(FIXED) logged to run.dat, save_state, then resume in a fresh
    manager. Returns (directory, per-rank results)."""
    cwd = tmp_path_factory.mktemp("golden_ranks")
    script = rank_script(cwd / "ranks.py", _GOLDEN_RANKS.format(fixed=FIXED))
    torchrun([script, *GOLDEN_ARGV, "--sample-shards", "-1", "--device", "cpu",
              "--output", "run.dat"], cwd)
    return cwd, rank_results(cwd)


def golden_config(**kw):
    """GOLDEN_ARGV as a JAX-package config."""
    cfg = JaxProblemConfig(refinements=1, dtype="float64", batch_size=16, initial_samples=16,
                           variance=0.25, seed=5, mse=2e-4, cost_model="dofs",
                           output_filename="", **kw)
    cfg.darcy_solver.relative_tolerance = 1e-12
    cfg.darcy_solver.max_iterations = 400
    return cfg


def in_process(output=""):
    """The port's manager on SampleMesh(2) in this process, GOLDEN_ARGV's
    config, after init_run(FIXED)."""
    TimeManager.reset()
    tcfg = port_config(golden_config())
    tcfg.output_filename = output
    prob = build_problem(tcfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, tcfg, sharding=SampleMesh(2))
    mgr.init_run(FIXED)
    return mgr


def test_two_ranks_match_the_in_process_shards_and_jax(golden_ranks):
    """Fixed counts on 2 ranks: per-level sums equal to the in-process
    SampleMesh(2) run to 1e-12 and to the JAX package's 2-device run to
    1e-9; every rank holds the same sums."""
    _, ranks = golden_ranks
    assert [r["shards"] for r in ranks] == [2, 2] and all(r["distributed"] for r in ranks)
    assert ranks[0]["sums"] == ranks[1]["sums"] and ranks[0]["nsamples"] == FIXED
    got = np.array(ranks[0]["sums"])
    mgr = in_process()
    np.testing.assert_allclose(got, mgr.sums, rtol=1e-12, atol=1e-14)
    jcfg = golden_config()
    jprob = jax_build_problem(jcfg)
    jmgr = JaxMLMCManager(jprob.solver, jprob.sampler, jcfg,
                          sharding=JaxSampleMesh(devices=jax.devices()[:2]))
    jmgr.init_run(FIXED)
    np.testing.assert_allclose(got, jmgr.sums, rtol=1e-9, atol=1e-12)


def test_rank_zero_writes_the_log_and_the_checkpoint_once(golden_ranks, tmp_path):
    """The per-sample log holds each global sample once (the in-process
    run's lines), save_state writes on rank 0 alone, and resume on 2 ranks
    gives the in-process resume's estimate and counts."""
    cwd, ranks = golden_ranks
    assert [r["writes"] for r in ranks] == [["state.npz"], []]
    log = str(tmp_path / "run.dat")
    mgr = in_process(log)
    mgr.close()
    got = np.loadtxt(os.path.join(cwd, "run.dat"), comments="%")
    want = np.loadtxt(log, comments="%")
    assert got.shape == want.shape == (sum(FIXED), 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mgr.save_state(str(tmp_path / "state.npz"))
    resumed = MLMCManager(mgr.solver, mgr.sampler, mgr.config, sharding=SampleMesh(2))
    est = resumed.resume(str(tmp_path / "state.npz"))
    assert resumed.level_nsamples.sum() > sum(FIXED)  # the target asked for more rounds
    for r in ranks:
        assert r["resumed_nsamples"] == resumed.level_nsamples.tolist()
        np.testing.assert_allclose(r["estimate"], est, rtol=1e-12)


_DECISION_RANKS = """
import torch.distributed as dist
from parelagmc_tpu_torch.examples import mlmc
from parelagmc_tpu_torch.utils.timing import SteadyCostLedger

if not dist.is_initialized():
    dist.init_process_group("gloo")
if rank == 1:  # this rank reads level 0 four times as expensive
    cost = SteadyCostLedger.cost_per_sample
    SteadyCostLedger.cost_per_sample = (
        lambda self, level, *a: cost(self, level, *a) * (4.0 if level == 0 else 1.0))
managers = []


class Recorded(mlmc.MLMCManager):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        managers.append(self)


mlmc.MLMCManager = Recorded
est = mlmc.main(sys.argv[1:])
json.dump(dict(nsamples=managers[0].level_nsamples.tolist(), estimate=est,
               cost=managers[0].cost.tolist()), open(f"rank{rank}.json", "w"))
"""


def test_ranks_take_one_decision_from_different_clocks(tmp_path):
    """The mlmc driver's adaptive walltime run on 2 ranks, rank 1 fed a
    level-0 cost four times its own reading: both ranks end with the same
    N_l, C_l and estimate (C_l is agreed over the ranks before it sets
    N_l), inside the deadline."""
    script = rank_script(tmp_path / "ranks.py", _DECISION_RANKS)
    out, _ = torchrun([script, "--refinements", "1", "--dtype", "float64", "--batch", "8",
                       "--samples", "8", "--mse", "0.002", "--sample-shards", "-1", "--device",
                       "cpu"], tmp_path)
    r0, r1 = rank_results(tmp_path)
    assert r0 == r1
    assert sum(r0["nsamples"]) > 16  # the adaptive loop took rounds after the first
    assert out.count("FINAL MLMC ERRORS") == 1  # rank 0 prints


_SPATIAL_RANKS = """
from parelagmc_tpu_torch.examples import spe10_mlmc
from parelagmc_tpu_torch.uq import MLMCManager

steps = []
step_of = MLMCManager._step


def recorded(self, level):
    step = step_of(self, level)

    def run(key):
        out = step(key)
        steps.append([level] + [t.double().tolist() for t in out])
        return out
    return run


MLMCManager._step = recorded
mgr = spe10_mlmc.main(sys.argv[1:])
slabs = type(mgr.solver._spatial(0).comm).__name__
json.dump(dict(steps=steps, slabs=slabs), open(f"rank{rank}.json", "w"))
"""
SPATIAL_ARGV = ["--grid", "16,32,8", "--refinements", "1", "--spatial-shards", "2", "--samples",
                "8", "--batch", "8", "--dtype", "float64", "--device", "cpu"]


def test_spatial_driver_on_two_ranks_matches_the_stacked_run(tmp_path, monkeypatch):
    """spe10_mlmc --spatial-shards 2 on 2 ranks (a slab a rank,
    DistributedSlabs) against the same driver stacked in this process: per
    sample Q and Q_c to 1e-12 (tests/test_torch_spatial.py's tolerance),
    equal iteration counts, on every step of the run."""
    script = rank_script(tmp_path / "ranks.py", _SPATIAL_RANKS)
    torchrun([script, *SPATIAL_ARGV], tmp_path)
    ranks = rank_results(tmp_path)
    assert [r["slabs"] for r in ranks] == ["DistributedSlabs"] * 2
    assert ranks[0]["steps"] == ranks[1]["steps"]
    steps = []
    step_of = MLMCManager._step

    def recorded(self, level):
        step = step_of(self, level)

        def run(key):
            out = step(key)
            steps.append([level] + [t.double().tolist() for t in out])
            return out
        return run

    monkeypatch.setattr(MLMCManager, "_step", recorded)
    TimeManager.reset()
    mgr = spe10_mlmc.main(SPATIAL_ARGV)
    assert type(mgr.solver._spatial(0).comm).__name__ == "StackedSlabs"
    got = ranks[0]["steps"]
    assert [s[0] for s in got] == [s[0] for s in steps] and len(got) >= 2
    for a, b in zip(got, steps):
        for name, x, y in zip(("q", "qc"), a[1:3], b[1:3]):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-300, err_msg=f"L{a[0]} {name}")
        assert a[3] == b[3], f"iterations L{a[0]}"


def test_graft_dry_run_on_two_ranks_uses_the_distributed_forms(tmp_path):
    """python -m parelagmc_tpu_torch.graft_entry on 2 ranks: entry() and
    dryrun_multichip(2), whose checks hold, in SampleMesh(2,
    distributed=True) and DistributedSlabs; rank 0 prints."""
    out, _ = torchrun(["-m", "parelagmc_tpu_torch.graft_entry", "--device", "cpu"], tmp_path)
    assert out.count("entry ok: [(8,), (8,)]") == 1
    assert out.count("dryrun_multichip(2) ok: sample mesh distributed, spatial slabs "
                     "DistributedSlabs") == 1


def test_no_fallback_under_torchrun(monkeypatch):
    """Under torchrun's environment on a host without CUDA, the default
    device and --device cuda raise (no CPU, no gloo); with a card the rank
    binds cuda:LOCAL_RANK and its group is NCCL with that device_id."""
    import torch.distributed as dist

    from parelagmc_tpu_torch.device import resolve_device
    from parelagmc_tpu_torch.examples.common import parse_args
    from parelagmc_tpu_torch.parallel import launch

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for call in (lambda: resolve_device(None), lambda: launch.init_from_env(None),
                 lambda: launch.init_from_env("cuda"), lambda: parse_args(["--device", "cuda"]),
                 lambda: parse_args([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not dist.is_initialized()

    inits = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: inits.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: inits.append((backend, kw)))
    monkeypatch.setattr(launch, "distributed_ready", lambda: False)
    assert resolve_device("cuda") == resolve_device(None) == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert launch.init_from_env(None) == torch.device("cuda", 1)
    assert inits == [("set_device", torch.device("cuda", 1)),
                     ("nccl", {"device_id": torch.device("cuda", 1)})]
    monkeypatch.delenv("WORLD_SIZE")
    assert resolve_device(None) == torch.device("cuda", 0)
