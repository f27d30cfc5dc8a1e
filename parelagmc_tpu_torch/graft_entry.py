"""Entry points: the golden forward step and the multi-device dry run.

Twin of __graft_entry__.py on the port.

* entry() returns (fn, example_args): the flagship forward step - one
  batched MLMC fine-pair realization (SPDE Matern sample -> coupled
  fine/coarse Darcy solves -> QoI) on the golden box configuration. fn is
  a plain callable (there is no jit).
* dryrun_multichip(n) runs the estimator step sample-sharded n ways
  (parallel/sharding.SampleMesh), composed with split_pair_programs, and a
  spatially sharded (dp, sp) Darcy solve, and checks each against its
  unsharded counterpart, as the JAX dry run does. Without a process group
  it uses the in-process forms: SampleMesh(n) runs its n shards one after
  the other, and the (dp, sp) spatial solve keeps its slabs stacked on one
  device, so it runs on one card or on the CPU. Under a group of world size
  n (torchrun) it uses the distributed forms: SampleMesh(n,
  distributed=True), a shard a rank, and DistributedSlabs, a slab a rank
  (slab_comm). The JAX dry run's platform set-up (XLA_FLAGS, jax_platforms,
  the device-count check) has no counterpart.

Both run on cuda:0 unless given another device, and raise without a card.

Usage: python -m parelagmc_tpu_torch.graft_entry [--device cpu]
       (dryrun_multichip(8) in one process), or on every card of a host:
       python -m torch.distributed.run --standalone --nproc-per-node N \
           -m parelagmc_tpu_torch.graft_entry   (dryrun_multichip(N))
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device, synchronize, torch_dtype
from parelagmc_tpu_torch.fem import build_geometric_hierarchy, build_geometric_hierarchy_from_fine
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.parallel import SampleMesh
from parelagmc_tpu_torch.parallel.launch import (distributed_ready, init_from_env, is_main,
                                                  world_size)
from parelagmc_tpu_torch.physics import DarcySolver
from parelagmc_tpu_torch.samplers import SPDESampler
from parelagmc_tpu_torch.uq import MLMCManager

# The dry run's limits, those of __graft_entry__.py.
SHARDED_SE = 6.0  # sharded against unsharded E[Q]: standard errors
SPLIT_RTOL = 5e-4  # split_pair_programs against the composed step
SPATIAL_RESIDUAL = 1e-3  # the sharded solve's final |r| / |b|
SPATIAL_Q_RTOL = 5e-3  # sharded against unsharded Q, cold and warm
WARM_ITERATIONS = 1  # the warm solve from the converged pressure
N_DEVICES = 8  # the dry run's width without a process group


def _require(ok: bool, *what) -> None:
    if not ok:
        raise AssertionError(what)


def build(nlevels=2, base_cells=(4, 4, 4), batch=8, dtype="float32", device=None):
    """(hierarchy, sampler, solver, config) on a box of side 2."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    base = make_box_mesh(base_cells, lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(base, nlevels)
    cfg = ProblemConfig(refinements=nlevels - 1, batch_size=batch)
    cfg.darcy_solver.relative_tolerance = 1e-5
    sampler = SPDESampler(hier, cfg, dtype, device)
    solver = DarcySolver(hier, cfg, dtype, device)
    return hier, sampler, solver, cfg


def entry(device=None):
    """(fn, example_args) of the golden forward step: a 2-level 4^3 box,
    batch 8, float32, Darcy rtol 1e-5; fn(key) -> (q - qc, q)."""
    hier, sampler, solver, cfg = build(nlevels=2, base_cells=(4, 4, 4), batch=8,
                                        device=device)

    def forward_step(key):
        xi = sampler.sample(0, key, cfg.batch_size)
        s_f = sampler.eval(0, xi)
        s_c = sampler.eval(1, xi, xi_level=0)
        qc, _, _ = solver.solve_fwd(1, s_c)
        q, _, _ = solver.solve_fwd(0, s_f)
        return q - qc, q

    return forward_step, (PRNGKey(0),)


def spatial_problem(n_devices: int, device=None):
    """The dry run's spatial problem: (unsharded solver, (dp, sp)-sharded
    solver, fields w). An SPE10-shaped (5, 2n, 4) box of spacings
    (20, 10, 2) with kinv = exp(0.5 N), cg-schur at rtol 1e-5 (500
    iterations, local scaling), float32, cut along y into sp = n / dp slabs
    with dp = 2 sample rows (1 for odd n, and for n = 2, so that the y axis
    is cut at all: the port routes a solve through the slabs only for
    sp > 1); w = exp(0.3 N), 2 dp samples."""
    device = resolve_device(device)
    n_dp = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
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
    dsolver = DarcySolver(hier, cfg, torch.float32, device, kinv_ref=kinv)
    cfg_sp = config()
    cfg_sp.darcy_solver = dataclasses.replace(cfg.darcy_solver, spatial_shards=n_sp,
                                              spatial_sample_shards=n_dp)
    ssolver = DarcySolver(hier, cfg_sp, torch.float32, device, kinv_ref=kinv)
    w = torch.as_tensor(np.exp(rng.normal(size=(2 * n_dp, mesh.num_cells)) * 0.3),
                        dtype=torch.float32, device=device)
    return dsolver, ssolver, w


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the n-way sharded MLMC step, the same composed with
    split_pair_programs, and the (dp, sp) spatial solve, each checked
    against its unsharded counterpart (AssertionError otherwise); under a
    process group (whose world size must be n) in the distributed forms.
    Returns the numbers checked: per-level eQ of the sharded, unsharded and
    split runs and the standard errors; the spatial q_sp, q_ref, q_warm,
    the cold solve's max residual and the warm solve's iterations; and the
    forms that ran: "sample_mesh" ("distributed" or "in-process") and
    "slabs" (the spatial solve's communicator class, None for one slab)."""
    distributed = distributed_ready()
    if distributed and world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) under a process group of world size "
                         f"{world_size()}")
    sm = SampleMesh(n_devices, distributed=distributed)
    batch = 2 * n_devices
    hier, sampler, solver, cfg = build(nlevels=2, base_cells=(2, 2, 2), batch=batch,
                                        device=device)
    cfg.output_filename = ""
    mgr = MLMCManager(solver, sampler, cfg, sharding=sm)
    mgr.init_run([batch, batch])
    _require(int(mgr.level_nsamples.sum()) == 2 * batch, mgr.level_nsamples)
    _require(np.isfinite(mgr.eY).all() and np.isfinite(mgr.varY).all(), mgr.eY, mgr.varY)
    # Estimator-grade parity: an unsharded manager drawing from the same
    # law agrees within Monte Carlo error.
    mgr_ref = MLMCManager(solver, sampler, cfg)
    mgr_ref.init_run([batch, batch])
    n = float(batch)
    se = np.sqrt(mgr.varQ / n + mgr_ref.varQ / n)
    for lvl in range(2):
        _require(abs(float(mgr.eQ[lvl] - mgr_ref.eQ[lvl])) < SHARDED_SE * se[lvl] + 1e-12,
                 lvl, float(mgr.eQ[lvl]), float(mgr_ref.eQ[lvl]), float(se[lvl]))

    # split_pair_programs: the port runs the step composed, with the same
    # per-shard keys and warm-start handoff, so the statistics agree.
    cfg.split_pair_programs = True
    mgr_split = MLMCManager(solver, sampler, cfg, sharding=sm)
    mgr_split.init_run([batch, batch])
    cfg.split_pair_programs = False
    _require(np.allclose(mgr_split.eQ, mgr.eQ, rtol=SPLIT_RTOL, atol=1e-8), mgr_split.eQ,
             mgr.eQ)

    # Spatial domain decomposition with the real Darcy operators through
    # the config surface on a (dp, sp) layout: cold and warm-started solves
    # reproduce the unsharded solver's QoI.
    dsolver, ssolver, w = spatial_problem(n_devices, device)
    q_ref, _, _, p_ref = dsolver.solve_fwd(0, w, return_pressure=True)
    q_sp, _, info_sp = ssolver.solve_fwd(0, w)
    residual = float(info_sp.residual.max())
    _require(residual < SPATIAL_RESIDUAL, residual)
    _require(torch.allclose(q_sp, q_ref, rtol=SPATIAL_Q_RTOL, atol=0), q_sp, q_ref)
    # From the converged pressure the sharded solve exits at once.
    q_w, _, info_w = ssolver.solve_fwd_x0(0, w, p_ref)
    _require(int(info_w.iterations) <= WARM_ITERATIONS, info_w.iterations)
    _require(torch.allclose(q_w, q_ref, rtol=SPATIAL_Q_RTOL, atol=0), q_w, q_ref)
    host = lambda t: t.detach().cpu().double().numpy()
    slabs = type(ssolver._spatial(0).comm).__name__ if ssolver._use_spatial(0) else None
    return dict(eQ=np.asarray(mgr.eQ), eQ_ref=np.asarray(mgr_ref.eQ),
                eQ_split=np.asarray(mgr_split.eQ), se=se, q_sp=host(q_sp), q_ref=host(q_ref),
                q_warm=host(q_w), residual=residual, warm_iterations=int(info_w.iterations),
                sample_mesh="distributed" if sm.distributed else "in-process", slabs=slabs)


def main(argv=None) -> dict:
    """entry()'s step once, then dryrun_multichip over the world size under
    torchrun (N_DEVICES without it); rank 0 prints. Returns the dry run's
    numbers."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0, cuda:LOCAL_RANK under torchrun; "
                        "without a card pass --device cpu)")
    device = init_from_env(p.parse_args(argv).device)
    fn, args = entry(device)
    out = fn(*args)
    synchronize(device)
    n = world_size() if distributed_ready() else N_DEVICES
    if is_main():
        print("entry ok:", [tuple(o.shape) for o in out])
    result = dryrun_multichip(n, device)
    if is_main():
        print(f"dryrun_multichip({n}) ok: sample mesh {result['sample_mesh']}, spatial slabs "
              f"{result['slabs']}")
    return result


if __name__ == "__main__":
    main()
