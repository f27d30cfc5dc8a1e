"""Spatial domain decomposition: sharded against replicated Darcy solves.

Twin of examples/spatial_scaling.py on the port. For an SPE10-shaped level
(the SPE10 extents on --grid, synthetic permeability) it compares the
replicated solve with the spatially sharded one (parallel/spatial_darcy.py)
- Krylov iterations, residual, converged fraction and the QoI error
against a deep-converged solve - for the slab-Jacobi and two-level Schwarz
coefMG preconditioners, the adjoint-corrected QoI and the composed
(dp, sp) sharding, and writes the table as JSON.

Memory: in place of the JAX driver's XLA temp size per device, each run
records `peak_mb`, torch.cuda.max_memory_allocated around its solve (null
on the CPU), and `execution`: "stacked" (every slab in this process: the
peak is ALL slabs on one device, not a per-device figure) or "distributed"
(one slab per torch.distributed rank, as under torchrun: the peak of this
rank's device). The JAX driver's --platform switch has no meaning here and
is not accepted.

Usage: python -m parelagmc_tpu_torch.examples.spatial_scaling
       [--grid 60,110,42] [--shards 8] [--batch 2] [--device cuda:0]
"""

import argparse
import dataclasses
import json

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device, torch_dtype
from parelagmc_tpu_torch.fem.hierarchy import build_geometric_hierarchy_from_fine
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING, make_box_mesh
from parelagmc_tpu_torch.parallel.spatial_darcy import SpatialDarcy
from parelagmc_tpu_torch.physics import DarcySolver
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv

DEFAULT_OUT = "spatial_scaling_torch.json"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="60,110,42")
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0; without a card pass "
                        "--device cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dt = torch_dtype(args.dtype)

    grid = tuple(int(x) for x in args.grid.split(","))
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    mesh = make_box_mesh(grid, spacings=[L / n for L, n in zip(lengths, grid)])
    kinv = load_spe10_kinv(None, ncells=grid)
    hier = build_geometric_hierarchy_from_fine(mesh, 1)

    def solver_for(name, **override):
        cfg = ProblemConfig(mesh="box", ncells=grid, lengths=lengths, refinements=0,
                            dtype=args.dtype)
        cfg.darcy_solver.name = name
        cfg.darcy_solver.relative_tolerance = args.rtol
        cfg.darcy_solver.max_iterations = 20000
        cfg.darcy_solver.local_schur_scaling = True
        solver = DarcySolver(hier, cfg, dt, device=device, kinv_ref=kinv)
        solver.solver_cfg = dataclasses.replace(solver.solver_cfg, **override)
        return solver

    rng = np.random.default_rng(0)
    w = torch.as_tensor(np.exp(rng.normal(size=(args.batch, mesh.num_cells)) * 0.5), dtype=dt,
                        device=device)
    results = {"grid": grid, "shards": args.shards, "batch": args.batch, "rtol": args.rtol,
               "dtype": args.dtype, "device": str(device),
               "kinv_contrast": float(kinv.max() / kinv.min()), "runs": {}}

    def measured(solve):
        """(result, peak MB of the device over the solve, or None on the CPU)."""
        if device.type != "cuda":
            return solve(), None
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = solve()
        torch.cuda.synchronize(device)
        return out, torch.cuda.max_memory_allocated(device) / 1e6

    # The deep-converged truth every run is scored against (equal-rtol QoI
    # errors are Krylov errors, which depend on the preconditioner).
    deep = solver_for("cg-schur-coefmg", relative_tolerance=min(args.rtol * 1e-3, 1e-9))
    q_true = deep.solve_fwd(0, w)[0].double().cpu().numpy()
    err = lambda q: float(np.max(np.abs((q.double().cpu().numpy() - q_true) / q_true)))

    def replicated(tag, solver):
        (q, _, info), peak = measured(lambda: solver.solve_fwd(0, w))
        results["runs"][tag] = {
            "iterations": int(info.iterations), "qoi_rel_err_vs_deep": err(q),
            "converged_fraction": float(info.converged.double().mean()),
            "peak_mb": peak, "execution": "replicated"}

    def sharded(tag, sp, adjoint=False):
        (q, it, rel, conv), peak = measured(lambda: sp.solve_fwd(w, adjoint=adjoint))
        results["runs"][tag] = {
            "iterations": int(it.max()), "relres": float(rel.max()),
            "converged_fraction": float(conv.double().mean()), "qoi_rel_err_vs_deep": err(q),
            "peak_mb": peak, "execution": sp.execution}

    solver = solver_for("cg-schur-coefmg")
    replicated("replicated-coefmg", solver)
    sharded("sharded-jacobi", SpatialDarcy.from_darcy(solver_for("cg-schur"), 0,
                                                      n_sp=args.shards))
    sp_mg = SpatialDarcy.from_darcy(solver, 0, n_sp=args.shards)
    sharded("sharded-coefmg-2level", sp_mg)
    results["runs"]["sharded-coefmg-2level"]["handoff_level"] = sp_mg.k_handoff
    # The production configuration: the adjoint-corrected QoI, replicated
    # and inside the sharded solve.
    replicated("replicated-adjoint", solver_for("cg-schur-coefmg", adjoint_qoi=True))
    sharded("sharded-adjoint", sp_mg, adjoint=True)
    # Tight rtol: what the flux QoI's accuracy costs without the adjoint.
    tight = solver_for("cg-schur-coefmg", relative_tolerance=args.rtol * 1e-2)
    sharded("sharded-coefmg-2level-tight", SpatialDarcy.from_darcy(tight, 0, n_sp=args.shards))
    if args.shards % 2 == 0 and args.batch % 2 == 0:
        sp_dpxsp = SpatialDarcy.from_darcy(solver, 0, n_sp=args.shards // 2, n_dp=2)
        sharded("sharded-dpxsp-coefmg", sp_dpxsp)
        sharded("sharded-dpxsp-adjoint", sp_dpxsp, adjoint=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    fmt = lambda v: "-" if v is None else f"{v:.1f}"
    print(f"{'config':30s} {'iters':>6s} {'peak MB':>10s} {'execution':>12s} {'dQ/Q vs deep':>13s}")
    for tag, r in results["runs"].items():
        print(f"{tag:30s} {r['iterations']:6d} {fmt(r['peak_mb']):>10s} {r['execution']:>12s} "
              f"{r['qoi_rel_err_vs_deep']:13.1e}")
    print("peak MB: torch.cuda.max_memory_allocated over the solve; a stacked run holds all "
          "slabs on one device")
    print(f"written: {args.out}")
    return results


if __name__ == "__main__":
    main()
