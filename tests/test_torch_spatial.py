"""The port's spatial sharding beyond the stacked Darcy solve: the
generic-CSR SpatialSolver (parallel/spatial.py) against scipy's spsolve and
the JAX package's SpatialSolver on the same operator, and the
torch.distributed execution of parallel/slabs.py (gloo processes on the
CPU) against the stacked one, for SpatialDarcy, DarcySolver's routing and
SpatialSolver. Every spawned run has a deadline (the process group's
timeout and a join timeout here, after which the processes are killed), so
a deadlock fails the test instead of stalling the suite."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from _torch_parity import CPU, general_mesh
from parelagmc_tpu.parallel.spatial import SpatialSolver as JaxSpatialSolver
from parelagmc_tpu_torch.parallel.spatial import (
    SpatialSolver,
    build_sharded_operator,
    slab_partition,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
DEADLINE = 180  # seconds for a spawned run, process start-up included


def _sampler_system():
    """The SPDE sampler's reduced SPD system A = M + 25 B^T W^-1 B with
    identity rows at boundary faces, on a generated tet cube (48 tets
    refined once), and face points between the adjacent cell centres."""
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu_torch.mesh import mfem_io

    hier = build_simplicial_hierarchy(general_mesh(mfem_io, (2, 2, 2)), 2)
    lvl = hier.levels[0]
    ess = lvl.bdr_attr > 0
    A = (lvl.mass_csr() + 25.0 * (lvl.b_csr().T @ sp.diags(1.0 / lvl.W) @ lvl.b_csr())).tolil()
    idx = np.nonzero(ess)[0]
    A[idx, :] = 0.0
    A[:, idx] = 0.0
    A[idx, idx] = 1.0
    cc = lvl.mesh.vertices[np.stack(lvl.mesh.elements)].mean(axis=1)
    other = np.where(lvl.face_signs[:, 1] != 0.0, lvl.face_cells[:, 1], lvl.face_cells[:, 0])
    return A.tocsr(), 0.5 * (cc[lvl.face_cells[:, 0]] + cc[other])


def test_slab_partition_balanced_contiguous():
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(64, 3))
    slab = slab_partition(pts, 8)
    assert np.bincount(slab).tolist() == [8] * 8
    a = int(np.argmax(pts.max(0) - pts.min(0)))
    order = np.argsort(pts[:, a], kind="stable")
    assert np.all(np.diff(slab[order]) >= 0)


def test_sharded_solve_matches_spsolve_and_jax():
    """8 slabs: the solution equals scipy's direct solve and the JAX
    package's SpatialSolver (8 virtual CPU devices) on the same CSR; the
    iteration counts (~590 Jacobi-PCG iterations) agree within 2, since
    rounding alone parts long solves by one or two."""
    A, pts = _sampler_system()
    solver = SpatialSolver(A, pts, n_sp=8, dtype=F64, device=CPU)
    assert solver.n_sp == 8 and not solver.comm.distributed
    rng = np.random.default_rng(3)
    b = rng.standard_normal((4, A.shape[0]))
    x, iters = solver.solve(b, max_iters=2000, rtol=1e-11)
    x_ref = np.stack([spla.spsolve(A.tocsc(), b[i]) for i in range(4)])
    np.testing.assert_allclose(x, x_ref, rtol=1e-6, atol=1e-9)
    xj, itj = JaxSpatialSolver(A, pts, dtype=jnp.float64).solve(b, max_iters=2000, rtol=1e-11)
    assert itj > 0 and abs(iters - itj) <= 2
    np.testing.assert_allclose(x, xj, rtol=1e-9, atol=1e-12)


def test_sharded_operator_rejects_non_1d_coupling():
    n = 32
    A = sp.eye(n).tolil()
    A[0, :] = 1.0
    A[:, 0] = 1.0
    slab = slab_partition(np.arange(n, dtype=np.float64)[:, None], 8)
    with pytest.raises(ValueError, match="non-adjacent"):
        build_sharded_operator(A.tocsr(), slab, 8, F64, device=CPU)


def test_padding_to_shard_multiple():
    """n = 30 over 8 slabs: identity-padded dofs keep the slabs equal and
    the solution is cut back to n; a single right-hand side comes back 1-D."""
    n = 30
    A = sp.diags([np.full(n - 1, -0.5), 2.0 + np.arange(n) * 0.01, np.full(n - 1, -0.5)],
                 [-1, 0, 1])
    solver = SpatialSolver(A.tocsr(), np.arange(n, dtype=np.float64)[:, None], n_sp=8,
                           dtype=F64, device=CPU)
    x, _ = solver.solve(np.ones(n), rtol=1e-12, max_iters=500)
    assert x.shape == (n,)
    np.testing.assert_allclose(x, spla.spsolve(A.tocsc(), np.ones(n)), rtol=1e-8)


# -- torch.distributed (gloo) -------------------------------------------------------

_COMMON = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import _torch_parity as cases
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), {world}
dist.init_process_group("gloo", init_method={url!r}, world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds={timeout}))
out = cases.{case}(rank)
if rank == 0:
    np.savez({out!r}, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, case: str, world: int) -> dict:
    """Run _torch_parity.<case>(rank) in `world` gloo processes; rank 0's
    result. Killed past DEADLINE seconds."""
    out = str(tmp_path / "rank0.npz")
    script = _COMMON.format(repo=REPO, tests=os.path.join(REPO, "tests"), world=world,
                            case=case, out=out, url=f"tcp://127.0.0.1:{_free_port()}", timeout=DEADLINE - 30)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=DEADLINE)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    return dict(np.load(out))


@pytest.mark.parametrize("case,world", [("darcy_sp2", 2), ("darcy_dp2_sp2", 4)])
def test_gloo_processes_match_the_stacked_form(tmp_path, case, world):
    """One slab per gloo process - 2 processes (n_sp = 2: the Jacobi and
    the adjoint-corrected solves with the pressure, DarcySolver's routing
    through an MLMC run, SpatialSolver), and 4 processes ((dp, sp) = (2,
    2): the two-level slab coefMG, whose global coarse level gathers over
    the processes) - give the stacked form's per-sample values to 1e-12
    and its iteration counts."""
    import _torch_parity as cases

    got = _spawn(tmp_path, case, world)
    want = getattr(cases, case)(None)
    assert set(got) == set(want) and got
    for k in want:
        if want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-14, err_msg=k)


def test_distributed_form_needs_a_process_group():
    from parelagmc_tpu_torch.parallel.slabs import DistributedSlabs, slab_comm

    assert not slab_comm(4).distributed
    with pytest.raises(ValueError, match="process group"):
        DistributedSlabs(2)


# -- the spatial_scaling driver twin ---------------------------------------------------

SCALING_RUNS = {"replicated-coefmg", "sharded-jacobi", "sharded-coefmg-2level",
                "sharded-coefmg-2level-tight", "sharded-dpxsp-coefmg"}


def _twin(tmp_path, monkeypatch):
    from parelagmc_tpu_torch.examples import spatial_scaling

    monkeypatch.chdir(tmp_path)
    spatial_scaling.main(["--grid", "8,16,6", "--batch", "2", "--out", "ev.json",
                          "--device", "cpu"])
    import json

    return json.load(open(tmp_path / "ev.json"))


def test_spatial_scaling_twin(tmp_path, monkeypatch):
    """The twin of examples/spatial_scaling.py on a tiny grid: the run set
    and error bounds of tests/test_examples.py::test_spatial_scaling_driver,
    every run converged, stacked, and no memory figure on the CPU; its
    default output is its own file; the JAX driver's --platform is
    refused."""
    from parelagmc_tpu_torch.examples import spatial_scaling

    runs = _twin(tmp_path, monkeypatch)["runs"]
    assert set(runs) >= SCALING_RUNS | {"sharded-adjoint", "sharded-dpxsp-adjoint"}
    for tag, r in runs.items():
        assert r["qoi_rel_err_vs_deep"] < 0.5, (tag, r)
        assert r["converged_fraction"] == 1.0 and r["peak_mb"] is None, (tag, r)
        assert r["execution"] == ("replicated" if tag.startswith("replicated") else "stacked")
    assert runs["sharded-coefmg-2level-tight"]["qoi_rel_err_vs_deep"] < 5e-3
    assert spatial_scaling.DEFAULT_OUT != "SPATIAL_EVIDENCE.json"
    with pytest.raises(SystemExit):
        spatial_scaling.main(["--platform", "cpu", "--device", "cpu"])


@pytest.mark.slow
def test_spatial_scaling_twin_matches_jax_driver(tmp_path, monkeypatch):
    """The twin's numbers against examples/spatial_scaling.py's on the same
    grid (8 virtual CPU devices, ~40 s): the same iterations per run and the
    same QoI errors to 1e-6 relative."""
    import json

    from examples import spatial_scaling as jax_driver

    got = _twin(tmp_path, monkeypatch)["runs"]
    jax_driver.main(["--grid", "8,16,6", "--batch", "2", "--out", "evj.json"])
    want = json.load(open(tmp_path / "evj.json"))["runs"]
    assert set(got) == set(want)
    for tag in want:
        assert got[tag]["iterations"] == want[tag]["iterations"], tag
        np.testing.assert_allclose(got[tag]["qoi_rel_err_vs_deep"],
                                   want[tag]["qoi_rel_err_vs_deep"], rtol=1e-6, err_msg=tag)


def test_spatial_scaling_twin_needs_a_device(tmp_path, monkeypatch):
    """Without a card and without --device the twin raises before any work;
    it never runs on the CPU unasked."""
    from parelagmc_tpu_torch.examples import spatial_scaling

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spatial_scaling.main(["--grid", "8,16,6"])
    assert not any(tmp_path.iterdir())
