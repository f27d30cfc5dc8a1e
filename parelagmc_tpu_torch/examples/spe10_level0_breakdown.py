"""Microbenchmark: component breakdown of the SPE10 level-0 pair solve.
Twin of examples/spe10_level0_breakdown.py.

Times, on the card, the pieces of one fine-level Schur-CG iteration at
full SPE10 scale (60x220x85, 4.5M Darcy dofs, batch 8):

* Minv          - exact M(w)^{-1} by the batched tridiagonal line solves
                  (ops/mass_solve.py, the K1 kernel), tables factored in
                  the call - one per CG iteration (apply_S)
* apply_S       - B M(w)^{-1} B^T (Minv + the two slicing stencils)
* v_cycle+setup - the per-sample Galerkin coefMG setup from diag M(w) and
                  one V(2,2) cycle (ops/coef_multigrid_structured.py, or
                  ops/coef_multigrid.py on a non-structured level), the
                  preconditioner application
* pcg_10        - ten full CG iterations (operator + preconditioner +
                  vector ops, the eager loop's per-iteration host sync
                  included)

The pair cost is iterations x (apply_S + v_cycle + vector ops), so the
component that dominates here is the one to attack. Each line gives the
CUDA-event ms per call over back-to-back calls, the synchronized host wall
per call beside it (both include the device's idle gaps between launches)
and the checksum (sum) of the component's output.

Usage: python -m parelagmc_tpu_torch.examples.spe10_level0_breakdown
        [--batch 8] [--grid 60,220,85] [--device cuda:0]
"""

import sys

import numpy as np
import torch

from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples._evidence import (call_ms, masked_dinv, normal_tensor,
                                                     spe10_probe_config)
from parelagmc_tpu_torch.examples.spe10_mlmc import parse_grid, take_option
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS
from parelagmc_tpu_torch.ops import coef_multigrid as cmg
from parelagmc_tpu_torch.ops import coef_multigrid_structured as cms
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.ops.solvers import pcg
from parelagmc_tpu_torch.problems import build_problem

REPS = {"pcg_10": 5}  # calls timed per component (10 unless named here)


def cycle_for(L, dinv0: torch.Tensor):
    """r -> one V(2,2) cycle of the level's coefMG (the structured or the
    gather form), set up from the masked diagonal inverse dinv0."""
    mg = L.coef_mg
    if isinstance(mg, cms.StructCoefMG):
        state = cms.struct_mg_setup(mg, dinv0)
        return lambda r: cms.struct_v_cycle(mg, state, r)
    dinvs = cmg.coef_mg_dinvs(mg, dinv0)
    return lambda r: cmg.coef_v_cycle(mg, dinvs, r)


def components(solver, w: torch.Tensor, r_u: torch.Tensor, r_s: torch.Tensor):
    """{label: (fn, argument)} of the level-0 pieces for the field w: one
    call of fn(argument) is what the label times."""
    L = solver.levels[0]
    apply_S = lambda p: solver._apply_B(L, L.mass_solver(w, solver._apply_Bt(L, p)))

    def pcg10(r):
        return pcg(apply_S, r, prec=cycle_for(L, masked_dinv(L, w)), max_iters=10, rtol=0.0)[0]

    return {
        "Minv": (lambda r: L.mass_solver(w, r), r_u),
        "apply_S": (apply_S, r_s),
        "v_cycle+setup": (lambda r: cycle_for(L, masked_dinv(L, w))(r), r_s),
        "pcg_10": (pcg10, r_s),
    }


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    batch = int(take_option(argv, "--batch") or 8)
    grid = parse_grid(take_option(argv, "--grid"))
    device = resolve_device(take_option(argv, "--device"))
    if argv:
        raise SystemExit(f"unknown arguments {argv}")
    cfg, kinv = spe10_probe_config(batch, grid or SPE10_NCELLS, box=grid is not None)
    cfg.darcy_solver.relative_tolerance = 1e-6
    cfg.darcy_solver.max_iterations = 150
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    solver, sampler = prob.solver, prob.sampler
    L = solver.levels[0]
    w = sampler.eval(0, sampler.sample(0, PRNGKey(0), batch))
    rng = np.random.default_rng(0)
    r_u = normal_tensor(rng, (batch, L.n_u), solver.dtype, device)
    r_s = normal_tensor(rng, (batch, L.n_s), solver.dtype, device)

    info = device_info(device)
    print(f"device: {info}")
    out = {"device": info, "batch": batch}
    for label, (fn, x) in components(solver, w, r_u, r_s).items():
        checksum = float(fn(x).sum())
        ms, wall = call_ms(lambda: fn(x), device, reps=REPS.get(label, 10), warmup=1)
        out[label] = dict(ms=ms, wall_ms=wall, checksum=checksum)
        print(f"{label:13s} {ms:8.3f} ms/call   (wall {wall:8.3f} ms/call; checksum "
              f"{checksum:.3e})")
    p, s, m, v = (out[k] for k in ("pcg_10", "apply_S", "Minv", "v_cycle+setup"))
    out["per_iteration"] = dict(pcg_ms=p["ms"] / 10, pcg_wall_ms=p["wall_ms"] / 10)
    print(f"per-iteration: pcg {p['ms'] / 10:.3f} ms (wall {p['wall_ms'] / 10:.3f}) | apply_S "
          f"{s['ms']:.3f} (Minv {m['ms']:.3f}) + v_cycle {v['ms']:.3f}")
    return out


if __name__ == "__main__":
    main()
