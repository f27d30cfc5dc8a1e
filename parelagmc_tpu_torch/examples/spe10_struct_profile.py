"""Amortized profile of the structured SPE10 level-0 Schur-CG components.
Twin of examples/spe10_struct_profile.py.

Every component is timed as a chain marginal: the component applied K
times in a row, each call on the output of the one before, against once,
and (t_K - t_1) / (K - 1) reported: the cost of one more application with
the chain's fixed cost (the first launch's latency, a final sync) taken
out. That is the number that enters the Schur-CG iteration cost. Each
chain is timed with CUDA events around back-to-back runs, with the
synchronized host wall beside it; both include the device's idle gaps
between launches.

Components (flat vectors in and out, so chains compose): M(w)^{-1} with
the tables factored in the call and factored once, B B^T, the Schur apply
B M(w)^{-1} B^T, the coefMG's level-0 S apply, one V(2,2) cycle, the
per-solve setup (coefMG state and mass tables), and one composed
preconditioned CG iteration.

Usage: python -m parelagmc_tpu_torch.examples.spe10_struct_profile
        [--batch 16] [--grid 12,44,16] [--device cuda:0]
"""

import sys

import numpy as np
import torch

from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples._evidence import (marginal, marginal_line, masked_dinv,
                                                     normal_tensor, spe10_probe_config)
from parelagmc_tpu_torch.examples.spe10_mlmc import parse_grid, take_option
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS
from parelagmc_tpu_torch.ops import coef_multigrid_structured as cms
from parelagmc_tpu_torch.problems import build_problem

K, REPS = 8, 6  # chain length and timed runs per chain


def probe_inputs(solver, batch: int, seed: int = 0):
    """(w, r_s, r_u) of the profiles: w = exp(0.5 N) on the cells, standard
    normal cell and face vectors, from numpy's default_rng(seed)."""
    L = solver.levels[0]
    rng = np.random.default_rng(seed)
    w = normal_tensor(rng, (batch, L.n_s), solver.dtype, solver.device, scale=0.5)
    r_s = normal_tensor(rng, (batch, L.n_s), solver.dtype, solver.device)
    r_u = normal_tensor(rng, (batch, L.n_u), solver.dtype, solver.device)
    return w, r_s, r_u


def components(solver, w: torch.Tensor, r_s: torch.Tensor, r_u: torch.Tensor):
    """{label: (fn, x0)} of the chained components for the field w."""
    L = solver.levels[0]
    mg = L.coef_mg
    if not isinstance(mg, cms.StructCoefMG):
        raise ValueError(f"the profile needs the structured coefMG, not {type(mg).__name__}")
    fac = L.mass_solver.factor(w)
    dinv0 = masked_dinv(L, w, fac)
    state = cms.struct_mg_setup(mg, dinv0)
    B, Bt = (lambda u: solver._apply_B(L, u)), (lambda p: solver._apply_Bt(L, p))
    minv = lambda r: L.mass_solver.apply_factored(fac, r)
    shape0 = mg.levels[0].shape

    def s0(x):
        xg = x.reshape(x.shape[:-1] + tuple(shape0[::-1]))
        return cms._s_apply_grid(state[0][0], xg).reshape(x.shape[:-1] + (-1,))

    def setup(d0):
        # Sums of every coefMG face table and of every mass table built from
        # a coefficient derived from d0, added to d0 so the chain composes.
        tables = sum(x.sum() for ent in cms.struct_mg_setup(mg, d0) for x in ent[0])
        return tables + sum(t.sum() for t in L.mass_solver.factor(torch.exp(-d0[..., :L.n_s]))) + d0

    return {
        "Minv(in-loop fac)": (lambda r: L.mass_solver(w, r), r_u),
        "Minv(factored)": (minv, r_u),
        "apply_Bt+B": (lambda p: B(Bt(p)), r_s),
        "apply_S": (lambda p: B(minv(Bt(p))), r_s),
        "mg_s_apply_0": (s0, r_s),
        "v_cycle": (lambda r: cms.struct_v_cycle(mg, state, r), r_s),
        "setup(dinv+idiag+fac)": (setup, dinv0),
        # One full preconditioned CG iteration's work, composed.
        "cg_iteration": (lambda p: cms.struct_v_cycle(mg, state, B(minv(Bt(p)))) + 1e-3 * p, r_s),
    }


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    batch = int(take_option(argv, "--batch") or 16)
    grid = parse_grid(take_option(argv, "--grid")) or SPE10_NCELLS
    device = resolve_device(take_option(argv, "--device"))
    if argv:
        raise SystemExit(f"unknown arguments {argv}")
    cfg, kinv = spe10_probe_config(batch, grid, box=tuple(grid) != tuple(SPE10_NCELLS))
    solver = build_problem(cfg, kinv_ref=kinv, device=device).solver
    info = device_info(device)
    print(f"device: {info}")
    print("mg level shapes:", [lvl.shape for lvl in solver.levels[0].coef_mg.levels])
    out = {"device": info, "batch": batch, "K": K}
    for label, (fn, x0) in components(solver, *probe_inputs(solver, batch)).items():
        out[label] = marginal(fn, x0, K, REPS, device)
        print(marginal_line(label, out[label], K, 22))
    return out


if __name__ == "__main__":
    main()
