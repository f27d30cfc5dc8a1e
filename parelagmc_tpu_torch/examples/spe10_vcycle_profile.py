"""Decompose the structured SPE10 V-cycle cost into its pieces, as chain
marginals (spe10_struct_profile's timing). Twin of
examples/spe10_vcycle_profile.py.

Times each structural piece of ops/coef_multigrid_structured._v_cycle_grid
at level 0 (batch 16, the full 60x220x85 grid): one Jacobi sweep, the
restrict-then-prolong round trip to level 1, the whole coarse cycle from
level 1 down, the full cycle with one and with two sweeps (V(1,1) against
the default V(2,2)), and the level-0 S apply alone, so the cycle's cost
can be put together from its parts.

Usage: python -m parelagmc_tpu_torch.examples.spe10_vcycle_profile
        [--batch 16] [--device cuda:0]
"""

import sys

import torch

from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples._evidence import (marginal, marginal_line, masked_dinv,
                                                     spe10_probe_config)
from parelagmc_tpu_torch.examples.spe10_mlmc import take_option
from parelagmc_tpu_torch.examples.spe10_struct_profile import K, REPS, probe_inputs
from parelagmc_tpu_torch.ops import coef_multigrid_structured as cms
from parelagmc_tpu_torch.problems import build_problem


def components(solver, w: torch.Tensor, r_s: torch.Tensor):
    """{label: (fn, x0)} of the V-cycle's pieces for the field w; the grid
    pieces take cell grids, the full cycles flat vectors."""
    L = solver.levels[0]
    mg = L.coef_mg
    if not isinstance(mg, cms.StructCoefMG) or len(mg.levels) < 2:
        raise ValueError("the profile needs a structured coefMG of two levels or more")
    state = cms.struct_mg_setup(mg, masked_dinv(L, w))
    bg = r_s.reshape(r_s.shape[:-1] + tuple(mg.levels[0].shape[::-1]))
    dinv_axes0, idiag0 = state[0][0], state[0][1]
    nxt = mg.levels[1]
    return {
        # One Jacobi sweep at level 0 (residual form).
        "jacobi_sweep_0": (lambda x: x + mg.omega * idiag0 * (bg - cms._s_apply_grid(dinv_axes0, x)),
                           bg),
        # Restrict level 0 -> level 1 and prolong back (the transfer round trip).
        "restrict+prolong_0to1": (lambda x: cms._prolong_cells(cms._restrict_cells(x, nxt), nxt),
                                  bg),
        # The whole coarse solve (levels 1 to the end) on a level-1 grid.
        "v_cycle_from_level_1": (lambda r1: cms._v_cycle_grid(mg, state, r1, 2, 1),
                                 cms._restrict_cells(bg, nxt)),
        "v_cycle_sweeps1": (lambda r: cms.struct_v_cycle(mg, state, r, sweeps=1), r_s),
        "v_cycle_sweeps2": (lambda r: cms.struct_v_cycle(mg, state, r, sweeps=2), r_s),
        # The level-0 S apply alone, for reference within this run.
        "s_apply_0": (lambda x: cms._s_apply_grid(dinv_axes0, x), bg),
    }


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    batch = int(take_option(argv, "--batch") or 16)
    device = resolve_device(take_option(argv, "--device"))
    if argv:
        raise SystemExit(f"unknown arguments {argv}")
    cfg, kinv = spe10_probe_config(batch)
    solver = build_problem(cfg, kinv_ref=kinv, device=device).solver
    info = device_info(device)
    print(f"device: {info}")
    print("mg level shapes:", [lvl.shape for lvl in solver.levels[0].coef_mg.levels])
    w, r_s, _ = probe_inputs(solver, batch)
    out = {"device": info, "batch": batch, "K": K}
    for label, (fn, x0) in components(solver, w, r_s).items():
        out[label] = marginal(fn, x0, K, REPS, device)
        print(marginal_line(label, out[label], K, 26))
    return out


if __name__ == "__main__":
    main()
