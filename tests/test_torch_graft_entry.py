"""The port's graft twin (parelagmc_tpu_torch/graft_entry.py) against
__graft_entry__.py on the CPU: entry()'s forward step against the JAX
entry() under jax.jit on PRNGKey(0), and dryrun_multichip(8) - which must
pass its own checks - against the JAX package's sharded manager on the 8
virtual devices of tests/conftest.py and its (dp, sp) = (2, 4) spatial
DarcySolver, built as in __graft_entry__.py:89-170."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import CPU, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import build_geometric_hierarchy_from_fine
from parelagmc_tpu.mesh.factories import make_box_mesh
from parelagmc_tpu.parallel import SampleMesh
from parelagmc_tpu.physics import DarcySolver
from parelagmc_tpu.uq import MLMCManager
from parelagmc_tpu_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import __graft_entry__ as jgraft  # noqa: E402

N_DEVICES = 8
# float32 solves at rtol 1e-5 in both packages; measured gaps: 5.2e-5 of
# max |q| (entry), 8.2e-7 relative (sharded eQ), 5.8e-7 (spatial q_sp) and
# 6.7e-8 (q_ref).
TOL = 1e-4


def test_entry_forward_step_matches_the_jax_entry():
    fn, args = graft_entry.entry(device=CPU)
    jfn, jargs = jgraft.entry()
    assert args == (tuple(int(v) for v in np.asarray(jax.random.key_data(jargs[0]))),)
    y, q = fn(*args)
    jy, jq = jax.jit(jfn)(*jargs)
    assert q.dtype == y.dtype and str(q.dtype) == "torch.float32" and q.shape == (8,)
    scale = float(np.max(np.abs(to_np(jq))))
    for a, b in ((q, jq), (y, jy)):
        gap = float(np.max(np.abs(to_np(a) - to_np(b))))
        assert gap <= TOL * scale, gap / scale


def jax_sharded_eq(n_devices):
    """eQ per level of __graft_entry__.py's sharded MLMC manager on n
    virtual devices."""
    devices = jax.devices()
    assert len(devices) >= n_devices
    batch = 2 * n_devices
    _, sampler, solver, cfg = jgraft._build(nlevels=2, base_cells=(2, 2, 2), batch=batch)
    cfg.output_filename = ""
    mgr = MLMCManager(solver, sampler, cfg, sharding=SampleMesh(devices=devices[:n_devices]))
    mgr.init_run([batch, batch])
    return np.asarray(mgr.eQ)


def jax_spatial_q(n_devices):
    """(q_sp, q_ref) of __graft_entry__.py's (dp, sp) spatial solve and its
    unsharded DarcySolver on the same fields."""
    n_dp = 2 if n_devices % 2 == 0 else 1
    n_sp = n_devices // n_dp
    ny = 2 * n_devices
    mesh = make_box_mesh((5, ny, 4), spacings=[20.0, 10.0, 2.0])
    hier = build_geometric_hierarchy_from_fine(mesh, 1)

    def config():
        return ProblemConfig(mesh="box", ncells=(5, ny, 4), lengths=(100.0, 10.0 * ny, 8.0),
                             refinements=0, dtype="float32")

    cfg = config()
    cfg.darcy_solver.name = "cg-schur"
    cfg.darcy_solver.relative_tolerance = 1e-5
    cfg.darcy_solver.max_iterations = 500
    cfg.darcy_solver.local_schur_scaling = True
    rng = np.random.default_rng(0)
    kinv = np.exp(rng.normal(size=(mesh.num_cells, 3)) * 0.5)
    dsolver = DarcySolver(hier, cfg, jnp.float32, kinv_ref=kinv)
    cfg_sp = config()
    cfg_sp.darcy_solver = dataclasses.replace(cfg.darcy_solver, spatial_shards=n_sp,
                                              spatial_sample_shards=n_dp)
    ssolver = DarcySolver(hier, cfg_sp, jnp.float32, kinv_ref=kinv)
    w = jnp.asarray(np.exp(rng.normal(size=(2 * n_dp, mesh.num_cells)) * 0.3),
                    dtype=jnp.float32)
    q_ref = dsolver.solve_fwd(0, w)[0]
    q_sp = ssolver.solve_fwd(0, w)[0]
    return np.asarray(q_sp, np.float64), np.asarray(q_ref, np.float64)


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(N_DEVICES, device=CPU)


def test_dryrun_passes_its_own_checks(dryrun):
    """The checks of __graft_entry__.py:100-176 hold (the call raised
    otherwise); the numbers it returns are those limits' inputs."""
    r = dryrun
    assert r["eQ"].shape == r["eQ_ref"].shape == r["eQ_split"].shape == r["se"].shape == (2,)
    assert np.all(np.abs(r["eQ"] - r["eQ_ref"]) < graft_entry.SHARDED_SE * r["se"] + 1e-12)
    np.testing.assert_allclose(r["eQ_split"], r["eQ"], rtol=graft_entry.SPLIT_RTOL)
    assert r["residual"] < graft_entry.SPATIAL_RESIDUAL
    assert r["warm_iterations"] <= graft_entry.WARM_ITERATIONS
    assert r["q_sp"].shape == r["q_ref"].shape == r["q_warm"].shape == (4,)
    for q in (r["q_sp"], r["q_warm"]):
        np.testing.assert_allclose(q, r["q_ref"], rtol=graft_entry.SPATIAL_Q_RTOL)


def test_dryrun_sharded_eq_matches_the_jax_sample_mesh(dryrun):
    np.testing.assert_allclose(dryrun["eQ"], jax_sharded_eq(N_DEVICES), rtol=TOL)


def test_dryrun_spatial_q_matches_the_jax_spatial_solver(dryrun):
    q_sp, q_ref = jax_spatial_q(N_DEVICES)
    np.testing.assert_allclose(dryrun["q_sp"], q_sp, rtol=TOL)
    np.testing.assert_allclose(dryrun["q_ref"], q_ref, rtol=TOL)


def test_dryrun_checks_fail_loudly():
    """A check that does not hold raises AssertionError with its numbers,
    under python -O too."""
    with pytest.raises(AssertionError, match="0.5"):
        graft_entry._require(False, 0.5)
    graft_entry._require(True, 0.5)
