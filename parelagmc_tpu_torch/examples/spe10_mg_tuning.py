"""Tune the per-sample coefMG preconditioner on the SPE10-contrast problem.
Twin of examples/spe10_mg_tuning.py.

Scans smoother configurations of the cg-schur-coefmg preconditioner
(Jacobi V(s,s) sweeps / damping, Chebyshev order and lower cutoff,
composed cycles) on a scaled SPE10 grid (synthetic permeability at the real
~1e6 contrast) and reports per configuration:

* Schur-CG iterations to the requested rtol,
* a cost proxy est_ms = iters * (t_schur + cycles * (t_ovh + t_apply *
  fine_S_applies) + (cycles - 1) * t_apply) from three component times
  measured on the device this run uses, at its own grid and batch, before
  the scan: t_schur one exact-Schur apply B M(w)^-1 B^T (its M(w)^-1 the
  tridiagonal mass solves), t_apply one fine-level S-apply of the coefMG,
  t_ovh one V-cycle of the production variant less its fine S-applies
  (transfers, coarse levels, elementwise work). CUDA events around
  back-to-back calls on a card; the host clock on the CPU. The proxy ranks
  candidates; adopt nothing without a measured run.

Iteration counts are hardware-independent (same operator, same Krylov
method); the component times are the device's own.

Reference analog: the preconditioner libraries the reference tunes via
ParameterLists (src/Utilities.cpp BoomerAMG/ADS solver blocks).

Devices: `--platform cpu` runs on the CPU (the original's JAX platform
switch, read here inside main); otherwise --device, default cuda:0, which
raises without a card.

Usage: python -m parelagmc_tpu_torch.examples.spe10_mg_tuning
        [--grid 30,110,42] [--rtol 1e-5] [--json F.json] [--quick]
        [--platform cpu] [--device cuda:0] [--batch 4] [--dtype float64]
"""

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from parelagmc_tpu_torch.device import device_info
from parelagmc_tpu_torch.examples._evidence import device_ms, host, masked_dinv
from parelagmc_tpu_torch.examples.common import is_main, parse_args, report
from parelagmc_tpu_torch.examples.spe10_mlmc import take_option
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.ops import coef_multigrid_structured as cms
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem


def fine_s_applies(cheby_order: int, sweeps: int) -> int:
    """Fine-level S-applies per V-cycle: pre-smooth from x=0 costs
    (sweeps-1) applies (the first sweep is free), + 1 residual + sweeps
    post-smooth applies; Chebyshev order k is the same with k sweeps."""
    s = cheby_order if cheby_order > 0 else sweeps
    return 2 * s


def est_ms(iters: float, cheby_order: int, sweeps: int, cycles: int, t: dict) -> float:
    """The cost proxy of one solve from the component times `t` (ms)."""
    per_cycle = t["t_ovh"] + t["t_apply"] * fine_s_applies(cheby_order, sweeps)
    return iters * (t["t_schur"] + cycles * per_cycle + (cycles - 1) * t["t_apply"])


def component_ms(prob, w: torch.Tensor, sweeps: int = 2) -> dict:
    """t_schur, t_apply and t_ovh (ms) of the level-0 solve of `w` under the
    problem's own coefMG (the production Jacobi V(2,2) variant)."""
    solver = prob.solver
    L = solver.levels[0]
    mg = L.coef_mg
    if not isinstance(mg, cms.StructCoefMG):
        raise ValueError("the cost proxy needs the structured coefMG (cg-schur-coefmg on a box)")
    fac = L.mass_solver.factor(w)
    state = cms.struct_mg_setup(mg, masked_dinv(L, w, fac))
    r = torch.ones_like(w)
    minv = lambda x: L.mass_solver.apply_factored(fac, x)
    t = {
        "t_schur": device_ms(lambda: solver._apply_B(L, minv(solver._apply_Bt(L, r))),
                             solver.device),
        "t_apply": device_ms(lambda: cms.struct_s_apply(mg, state, r), solver.device),
    }
    cycle = device_ms(lambda: cms.struct_v_cycle(mg, state, r, sweeps=sweeps), solver.device)
    t["t_ovh"] = cycle - fine_s_applies(0, sweeps) * t["t_apply"]
    return t


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    grid = (30, 110, 42)
    value = take_option(argv, "--grid")
    if value is not None:
        grid = tuple(int(x) for x in value.split(","))
    rtol = float(take_option(argv, "--rtol") or 1e-5)
    out_json = take_option(argv, "--json")
    quick = "--quick" in argv
    if quick:
        argv.remove("--quick")
    platform = take_option(argv, "--platform")
    if platform == "cpu":
        argv += ["--device", "cpu"]

    cfg0, device = parse_args(
        argv,
        mesh="spe10",
        refinements=0,
        correlation_length=100.0,
        initial_samples=4,
        batch_size=4,
        normalize_marginals=True,
        axis_order="auto",
        dtype="float64",
    )
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg0 = dataclasses.replace(cfg0, mesh="box", ncells=grid, lengths=lengths)
    cfg0.darcy_solver.name = "cg-schur-coefmg"
    cfg0.darcy_solver.max_iterations = 600
    cfg0.darcy_solver.relative_tolerance = rtol
    kinv = load_spe10_kinv(None, ncells=grid)

    # (label, config overrides on DarcySolverConfig)
    variants = [
        ("jac s2 w0.8 (prod)", {}),
        ("jac s1 w0.8", {"coefmg_sweeps": 1}),
        ("jac s3 w0.8", {"coefmg_sweeps": 3}),
        ("jac s2 w0.7", {"coefmg_omega": 0.7}),
        ("jac s2 w0.9", {"coefmg_omega": 0.9}),
        ("jac s2 w1.0", {"coefmg_omega": 1.0}),
        ("cheb k2 lo.25", {"coefmg_cheby_order": 2}),
        ("cheb k3 lo.25", {"coefmg_cheby_order": 3}),
        ("cheb k4 lo.25", {"coefmg_cheby_order": 4}),
        ("cheb k3 lo.10", {"coefmg_cheby_order": 3, "coefmg_cheby_lo": 0.10}),
        ("cheb k3 lo.15", {"coefmg_cheby_order": 3, "coefmg_cheby_lo": 0.15}),
        ("cheb k3 lo.35", {"coefmg_cheby_order": 3, "coefmg_cheby_lo": 0.35}),
        ("jac s2 x2cyc", {"coefmg_cycles": 2}),
        ("cheb k3 lo.15 x2cyc",
         {"coefmg_cheby_order": 3, "coefmg_cheby_lo": 0.15,
          "coefmg_cycles": 2}),
    ]
    if quick:
        variants = variants[:3]

    s_ref = None
    comp = None
    rows = []
    report(f"# grid {grid}  rtol {rtol:g}  batch {cfg0.batch_size}  "
           f"dtype {cfg0.dtype}  device {device}")
    for label, over in variants:
        cfg = dataclasses.replace(cfg0)
        cfg.darcy_solver = dataclasses.replace(cfg0.darcy_solver, **over)
        prob = build_problem(cfg, kinv_ref=kinv, device=device)
        if s_ref is None:
            xi = prob.sampler.sample(0, PRNGKey(cfg.seed), cfg.batch_size)
            s_ref = prob.sampler.eval(0, xi)
            comp = component_ms(prob, s_ref)
            report(f"# measured on {device_info(device)}: t_schur {comp['t_schur']:.4f} ms, "
                   f"t_ovh {comp['t_ovh']:.4f} ms, t_apply {comp['t_apply']:.4f} ms")
            report(f"{'config':22s} {'iters':>6s} {'conv':>5s} {'S/cyc':>6s} "
                   f"{'est_ms/solve':>12s} {'Q[0]':>10s}")
        t0 = time.perf_counter()
        q, _, info = prob.solver.solve_fwd(0, s_ref)
        q = host(q)
        iters = int(np.max(host(info.iterations)))
        conv = bool(np.all(host(info.converged)))
        dt = time.perf_counter() - t0
        ch = int(over.get("coefmg_cheby_order", 0))
        sw = int(over.get("coefmg_sweeps", 2))
        cy = int(over.get("coefmg_cycles", 1))
        ems = est_ms(iters, ch, sw, cy, comp)
        rows.append(
            dict(label=label, iters=iters, converged=conv,
                 s_applies=fine_s_applies(ch, sw) * cy, est_ms=ems,
                 q0=float(q[0]), cpu_s=dt, overrides=over, **comp)
        )
        report(f"{label:22s} {iters:6d} {str(conv):>5s} "
               f"{fine_s_applies(ch, sw) * cy:6d} {ems:12.1f} {q[0]:10.4f}")
    converged_rows = [r for r in rows if r["converged"]]
    if converged_rows:
        best = min(converged_rows, key=lambda r: r["est_ms"])
        report(f"# best by the measured proxy: {best['label']} "
               f"({best['iters']} iters, est {best['est_ms']:.0f} ms/solve)")
        qs = [r["q0"] for r in converged_rows]
        if max(qs) - min(qs) > 1e-3 * max(abs(q) for q in qs):
            report("# WARNING: converged QoIs disagree across "
                   "preconditioners - rtol too loose for this contrast")
    else:
        report("# WARNING: no variant converged within the iteration cap - "
               "loosen --rtol or raise the cap; rows still recorded")
    if out_json and is_main():
        with open(out_json, "w") as f:
            json.dump({"grid": grid, "rtol": rtol, "device": device_info(device),
                       "components_ms": comp, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
