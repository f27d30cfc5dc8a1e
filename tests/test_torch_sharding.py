"""Sample sharding of the port (parallel/sharding.py and the managers'
hooks) held against the JAX package's 'dp' shard_map on the 8 virtual CPU
devices of tests/conftest.py, in the configurations of tests/test_parallel.py
(2^3 box of side 2, float64): per-sample values of each level step, moment
sums, eY and eQ; the config surface (0/1 off, -1 every visible device, the
ValueErrors, the refusal to nest around spatial_shards); a sharded ratio
manager; two torch.distributed (gloo) processes against the in-process run;
and the managers' eval_pair hook."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.parallel import SampleMesh as JaxSampleMesh
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.uq import BayesianInverseProblem as JaxBIP
from parelagmc_tpu.uq import BayesRatioManager as JaxRatioManager
from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
from parelagmc_tpu.utils.timing import TimeManager as JaxTimeManager
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.parallel import SampleMesh
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager, MLMCManager
from parelagmc_tpu_torch.utils.timing import TimeManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def key_data(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def box_config(**kw):
    """tests/test_parallel.py's box with deep solves, so that the two
    packages' rounding stays below the compared digits."""
    args = dict(ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1, dtype="float64",
                mse=1e10, batch_size=16, initial_samples=16, output_filename="",
                cost_model="dofs", variance=0.25)
    cfg = ProblemConfig(**{**args, **kw})
    cfg.darcy_solver.relative_tolerance = 1e-12
    cfg.darcy_solver.max_iterations = 400
    return cfg


def both_managers(cfg, jax_sharding, port_sharding, nlevels=None):
    JaxTimeManager.reset()
    TimeManager.reset()
    jprob = jax_build_problem(cfg)
    jmgr = JaxMLMCManager(jprob.solver, jprob.sampler, cfg, nlevels=nlevels,
                          sharding=jax_sharding)
    tcfg = port_config(cfg)
    prob = build_problem(tcfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, tcfg, nlevels=nlevels, sharding=port_sharding)
    return jmgr, mgr


def assert_steps_equal(jmgr, mgr, key_seed=11):
    """Each level step's per-sample q and qc and the iteration sums."""
    for level in range(mgr.nlevels):
        key = jax.random.fold_in(jax.random.PRNGKey(key_seed), level)
        want = [np.asarray(x) for x in jmgr._step(level)(key)]
        got = [to_np(x) for x in mgr._step(level)(key_data(key))]
        for name, a, b in zip(("q", "qc", "iterations"), got, want):
            assert a.shape == b.shape == (mgr.level_batch[level],), name
            np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-14, err_msg=f"{name} L{level}")


def assert_stats_equal(jmgr, mgr, rtol=1e-12):
    np.testing.assert_array_equal(mgr.level_nsamples, jmgr.level_nsamples)
    np.testing.assert_allclose(mgr.sums, jmgr.sums, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(mgr.eY, jmgr.eY, rtol=rtol, atol=1e-14)
    np.testing.assert_allclose(mgr.eQ, jmgr.eQ, rtol=rtol, atol=1e-14)
    np.testing.assert_allclose(mgr.solver_iterations, jmgr.solver_iterations, rtol=1e-12)


def test_sharded_mlmc_manager_matches_jax():
    """tests/test_parallel.py::test_sharded_mlmc_manager: batch 12 rounded
    to 16 on 8 shards, two batches a level; the port's SampleMesh(8) in one
    process draws the JAX package's 8-device stream."""
    cfg = box_config(batch_size=12, initial_samples=24)
    jmgr, mgr = both_managers(cfg, JaxSampleMesh(), SampleMesh(8))
    assert mgr.batch == jmgr.batch == 16 and mgr.level_batch == [16, 16]
    assert_steps_equal(jmgr, mgr)
    jmgr.init_run([24, 24])
    mgr.init_run([24, 24])
    assert int(mgr.level_nsamples[0]) == 32
    assert_stats_equal(jmgr, mgr)
    assert 1.0 < mgr.eQ[1] < 5.0 and np.all(mgr.consistency[:1] < 1.0)


def test_sharded_matches_unsharded_statistics():
    """tests/test_parallel.py::test_sharded_matches_unsharded_statistics:
    one level, 256 samples; the sharded run is the JAX package's sharded
    run, and it agrees with the unsharded one within Monte Carlo error."""
    cfg = box_config(refinements=0, batch_size=64, initial_samples=256)
    jmgr, mgr = both_managers(cfg, JaxSampleMesh(), SampleMesh(8), nlevels=1)
    jmgr.init_run([256])
    mgr.init_run([256])
    assert_stats_equal(jmgr, mgr)
    plain = MLMCManager(mgr.solver, mgr.sampler, mgr.config, nlevels=1)
    plain.init_run([256])
    se = np.sqrt(plain.varQ[0] / 256 + mgr.varQ[0] / 256)
    assert abs(plain.eQ[0] - mgr.eQ[0]) < 5 * se
    assert plain.eQ[0] != mgr.eQ[0]  # another stream


@pytest.mark.parametrize("shards", [0, 1, -1])
def test_sample_shards_config_surface(shards):
    """0 and 1 run unsharded; -1 is every visible device: one on the CPU,
    so one shard keyed fold_in(key, 0) - the reference's one-device mesh -
    and the same stream as an explicit SampleMesh(1)."""
    cfg = box_config(seed=3, sample_shards=shards)
    jax_mesh = JaxSampleMesh(devices=jax.devices()[:1]) if shards == -1 else None
    jmgr, mgr = both_managers(cfg, jax_mesh, None)
    assert (mgr.sharding is None) == (shards in (0, 1)) == (jmgr.sharding is None)
    if shards == -1:
        assert mgr.sharding.n_devices == 1 and not mgr.sharding.distributed
    assert_steps_equal(jmgr, mgr)
    jmgr.init_run([16, 16])
    mgr.init_run([16, 16])
    assert_stats_equal(jmgr, mgr)
    explicit = MLMCManager(mgr.solver, mgr.sampler, port_config(box_config(seed=3)),
                           sharding=SampleMesh(1) if shards == -1 else None)
    explicit.init_run([16, 16])
    np.testing.assert_array_equal(explicit.sums, mgr.sums)


def test_sample_shards_refusals():
    """< -1 and more shards than visible devices raise ValueError naming
    sample_shards; sample sharding does not nest around spatial_shards; an
    explicit SampleMesh(n) in one process takes any n >= 1."""
    tcfg = port_config(box_config())
    prob = build_problem(tcfg, device=CPU)
    for n, match in ((-2, "invalid"), (2, "only 1 device"), (16, "only 1 device")):
        tcfg.sample_shards = n
        with pytest.raises(ValueError, match=f"sample_shards={n}.*{match}"):
            MLMCManager(prob.solver, prob.sampler, tcfg)
    tcfg.sample_shards = -1
    tcfg.darcy_solver.spatial_shards = 2
    with pytest.raises(ValueError, match="spatial_shards"):
        MLMCManager(prob.solver, prob.sampler, tcfg)
    with pytest.raises(ValueError, match="spatial_shards"):
        MLMCManager(prob.solver, prob.sampler, tcfg, sharding=SampleMesh(2))
    tcfg.darcy_solver.spatial_shards = 0
    tcfg.sample_shards = 0
    for n in (1, 3, 5):
        mgr = MLMCManager(prob.solver, prob.sampler, tcfg, batch_size=7, sharding=SampleMesh(n))
        assert mgr.batch == -(-7 // n) * n
        q, qc, iters = mgr._step(1)((0, 9))
        assert q.shape == iters.shape == (mgr.batch,) and bool((qc == 0).all())
    with pytest.raises(ValueError, match="at least one shard"):
        SampleMesh(0)
    with pytest.raises(ValueError, match="process group"):
        SampleMesh(2, distributed=True)


def test_batch_size_per_level_rounds_to_the_shards():
    tcfg = port_config(box_config(batch_size_per_level=[5, 9]))
    prob = build_problem(tcfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, tcfg, sharding=SampleMesh(4))
    assert mgr.batch == 16 and mgr.level_batch == [8, 12]


def test_shard_stage_runs_each_chunk():
    mesh = SampleMesh(3)
    stage = mesh.shard_stage(lambda a, b: (a + b.sum(), a * 0 + a.shape[0]))
    a, b = torch.arange(6.0), torch.ones(6)
    s, n = stage(a, b)
    np.testing.assert_array_equal(s.numpy(), np.arange(6.0) + 2.0)
    np.testing.assert_array_equal(n.numpy(), np.full(6, 2.0))
    step = mesh.shard_step(lambda key: (torch.tensor(key, dtype=torch.float64),))
    (keys,) = step(PRNGKey(4))
    want = [float(v) for i in range(3) for v in fold_in(PRNGKey(4), i)]
    np.testing.assert_array_equal(keys.numpy(), want)


def test_sharded_ratio_manager_matches_jax(tmp_path):
    """A ratio manager on 8 shards: per-batch r, rc, z, zc and the 20 moment
    sums equal the JAX package's sharded ratio manager's (the shard's fold
    is taken before the step's own split into the Z and R keys)."""
    cfg = box_config(batch_size=16, initial_samples=16, mse=5e-3, bayes_num_obs=0,
                     bayes_obs_coords=(0.5, 0.5, 0.5), bayes_eps=0.45, seed=13,
                     bayes_ref_data_file=str(tmp_path / "ref_obs.dat"))
    cfg.darcy_solver.relative_tolerance = 1e-10
    JaxTimeManager.reset()
    TimeManager.reset()
    jprob = jax_build_problem(cfg)
    jbip = JaxBIP(jprob.solver, jprob.sampler, jprob.config, jprob.dtype)
    prob = build_problem(port_config(cfg), device=CPU)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype)
    jbip.set_observational_data([0.55])
    bip.set_observational_data([0.55])
    jmgr = JaxRatioManager(jbip, cfg, sharding=JaxSampleMesh())
    mgr = BayesRatioManager(bip, prob.config, sharding=SampleMesh(8))
    for level in (1, 0):
        key = jax.random.fold_in(jax.random.PRNGKey(3), level)
        want = [np.asarray(x) for x in jmgr._step(level)(key)]
        got = [to_np(x) for x in mgr._step(level)(key_data(key))]
        for name, a, b in zip(("r", "rc", "z", "zc"), got, want):
            assert a.shape == b.shape == (16,)
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-14, err_msg=f"{name} L{level}")
    jmgr.init_run([16, 16])
    mgr.init_run([16, 16])
    np.testing.assert_allclose(mgr.sums, jmgr.sums, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(mgr.estimate, jmgr.estimate, rtol=1e-9)


_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
torch.set_num_threads(2)
from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MLMCManager
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={url!r}, world_size=2, rank=rank)
cfg = ProblemConfig(**{cfg!r})
cfg.darcy_solver.relative_tolerance = 1e-12
cfg.darcy_solver.max_iterations = 400
prob = build_problem(cfg, device="cpu")
mgr = MLMCManager(prob.solver, prob.sampler, cfg)
assert mgr.sharding.distributed and mgr.sharding.n_devices == 2 and mgr.sharding.rank == rank
q, qc, iters = mgr._step(0)((0, 21))
mgr.init_run([16, 16])
if rank == 0:
    np.savez({out!r}, sums=mgr.sums, q=q.numpy(), qc=qc.numpy(), iters=iters.numpy(),
             iter_sums=mgr._iter_sums)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_the_in_process_shards(tmp_path):
    """sample_shards = -1 under torch.distributed (gloo, world size 2): each
    rank runs its shard and all_gather gives every rank the global batch -
    the same per-sample values and sums as SampleMesh(2) in one process.
    The two processes get a deadline of 120 s and are killed past it."""
    kw = dict(ncells=(2, 2, 2), lengths=(2.0, 2.0, 2.0), refinements=1, dtype="float64",
              mse=1e10, batch_size=16, initial_samples=16, output_filename="",
              cost_model="dofs", variance=0.25, seed=4, sample_shards=-1)
    out = str(tmp_path / "rank0.npz")
    script = _RANK_SCRIPT.format(repo=REPO, url=f"tcp://127.0.0.1:{_free_port()}", cfg=kw,
                                 out=out)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], cwd=str(tmp_path),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    got = np.load(out)

    tcfg = port_config(box_config(seed=4))
    prob = build_problem(tcfg, device=CPU)
    mgr = MLMCManager(prob.solver, prob.sampler, tcfg, sharding=SampleMesh(2))
    q, qc, iters = mgr._step(0)((0, 21))
    mgr.init_run([16, 16])
    np.testing.assert_allclose(got["q"], q.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got["qc"], qc.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(got["iters"], iters.numpy())
    np.testing.assert_allclose(got["sums"], mgr.sums, rtol=1e-12)
    np.testing.assert_array_equal(got["iter_sums"], mgr._iter_sums)


class _PairCounting:
    """A sampler wrapper with eval_pair that counts its calls."""

    def __init__(self, sampler):
        self.inner, self.pairs = sampler, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def eval_pair(self, level, xi):
        self.pairs += 1
        return self.inner.eval(level, xi), self.inner.eval(level + 1, xi, xi_level=level)


def test_managers_call_the_samplers_eval_pair(tmp_path):
    """The pair steps of MLMCManager and the ratio managers take the
    coupled fields from the sampler's eval_pair where it has one."""
    tcfg = port_config(box_config(bayes_ref_data_file=str(tmp_path / "obs.dat")))
    prob = build_problem(tcfg, device=CPU)
    counting = _PairCounting(prob.sampler)
    mgr = MLMCManager(prob.solver, counting, tcfg)
    mgr._step(1)((0, 1))
    assert counting.pairs == 0  # the coarsest level evaluates alone
    ref = MLMCManager(prob.solver, prob.sampler, tcfg)._step(0)((0, 1))
    got = mgr._step(0)((0, 1))
    assert counting.pairs == 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    bip = BayesianInverseProblem(prob.solver, counting, tcfg, prob.dtype)
    bip.set_observational_data([0.5])
    BayesRatioManager(bip, tcfg)._step(0)((0, 2))
    assert counting.pairs == 3  # the Z and the R stream
