"""Measure the real SPE10 level-0 Schur-CG per-iteration cost by iteration
differencing. Twin of examples/spe10_iter_cost.py.

Times DarcySolver.solve_fwd at two forced iteration budgets (relative
tolerance 0, so every solve runs its whole budget) and reports
(t_hi - t_lo) / (hi - lo): the cost of one more iteration with everything
the composed profile (spe10_struct_profile) leaves out - the eager PCG
loop's per-iteration host sync and launches, its restarts, the convergence
bookkeeping - and the per-solve setup differenced away. Both the CUDA-event
time and the synchronized host wall are given; the host sync inside the
loop is part of what this measures.

--prec-dtype sets config.coefmg_prec_dtype (the reduced-precision V-cycle
state); repeatable --solver-opt KEY=VALUE as in examples/common
(coefmg_line_axes, coefmg_coarsen, coefmg_cheby_order, ...).

Usage: python -m parelagmc_tpu_torch.examples.spe10_iter_cost
        [--batch 16] [--lo 10] [--hi 30] [--prec-dtype bfloat16]
        [--solver-opt KEY=VALUE ...] [--device cuda:0]
"""

import sys

import torch

from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples._evidence import call_ms, host, spe10_probe_config
from parelagmc_tpu_torch.examples.common import apply_solver_opt
from parelagmc_tpu_torch.examples.spe10_mlmc import take_option
from parelagmc_tpu_torch.examples.spe10_struct_profile import probe_inputs
from parelagmc_tpu_torch.problems import build_problem

REPS = 5  # timed solves per budget


def budget_solve(solver, w: torch.Tensor, iters: int):
    """(q, info) of the level-0 solve of w at a budget of `iters`
    iterations (the solver's tolerance decides whether it stops earlier)."""
    q, _, info = solver.solve_fwd(0, w, max_iters=iters)
    return q, info


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    batch = int(take_option(argv, "--batch") or 16)
    lo = int(take_option(argv, "--lo") or 10)
    hi = int(take_option(argv, "--hi") or 30)
    prec_dtype = take_option(argv, "--prec-dtype")
    device = resolve_device(take_option(argv, "--device"))
    opts = []
    while "--solver-opt" in argv:
        opts.append(take_option(argv, "--solver-opt"))
    if argv:
        raise SystemExit(f"unknown arguments {argv}")
    cfg, kinv = spe10_probe_config(batch)
    cfg.darcy_solver.relative_tolerance = 0.0  # force the full budget
    if prec_dtype is not None:
        cfg.darcy_solver.coefmg_prec_dtype = prec_dtype
    for kv in opts:
        apply_solver_opt(cfg.darcy_solver, kv)
    solver = build_problem(cfg, kinv_ref=kinv, device=device).solver
    w, _, _ = probe_inputs(solver, batch)
    info = device_info(device)
    print(f"device: {info}")
    out = {"device": info, "batch": batch, "lo": lo, "hi": hi, "budgets": {}}
    for iters in (lo, hi):
        q, solve_info = budget_solve(solver, w, iters)
        ms, wall = call_ms(lambda: budget_solve(solver, w, iters), device, reps=REPS, warmup=0)
        out["budgets"][iters] = dict(ms=ms, wall_ms=wall, iterations=solve_info.iterations,
                                     q_sum=float(host(q).sum()))
        print(f"solve_fwd iters={iters}: {ms:.2f} ms/call (wall {wall:.2f} ms/call; "
              f"{solve_info.iterations} iterations)")
    t_lo, t_hi = out["budgets"][lo], out["budgets"][hi]
    per_it = (t_hi["ms"] - t_lo["ms"]) / (hi - lo)
    per_it_wall = (t_hi["wall_ms"] - t_lo["wall_ms"]) / (hi - lo)
    out.update(per_iteration_ms=per_it, per_iteration_wall_ms=per_it_wall,
               per_sample_iteration_ms=per_it / batch,
               per_sample_iteration_wall_ms=per_it_wall / batch)
    print(f"real per-iteration: {per_it:.3f} ms (wall {per_it_wall:.3f} ms) (batch {batch})")
    print(f"  = {per_it / batch:.4f} ms/sample/iteration (wall {per_it_wall / batch:.4f})")
    return out


if __name__ == "__main__":
    main()
