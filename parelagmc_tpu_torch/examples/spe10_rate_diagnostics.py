"""Decompose the MLMC correction Y_l = Q_l - Q_{l+1} on an SPE10-class
problem into its two error sources, per sample. Twin of
examples/spe10_rate_diagnostics.py.

    Y_field = Q_l(w_l)        - Q_l(P w_{l+1})   (sampler field mismatch,
                                                  same fine discretization)
    Y_disc  = Q_l(P w_{l+1})  - Q_{l+1}(w_{l+1}) (discretization + kinv
                                                  upscaling, same field)

with P the piecewise-constant prolongation of the coarse sample field
(hier.parent[level]): which mechanism carries the level variance, so that
a fix of the variance decay targets the right component.

Devices and precision: by default --device (cuda:0) in float64, the
reference's default precision; without a card that raises. `--cpu` asks
for the CPU (float64), and is no longer the default as it was in the
original; `--tpu` is accepted and means float32 on the chosen device (the
original's accelerator setting). It prints only.

Usage: python -m parelagmc_tpu_torch.examples.spe10_rate_diagnostics
        [--grid 16,56,16] [--n 64] [--nlevels 3] [--cpu | --device cuda:0]
        [--tpu]
"""

import argparse
import sys

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.examples._evidence import host
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="16,56,16")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nlevels", type=int, default=3)
    ap.add_argument("--corlen", type=float, default=100.0)
    ap.add_argument("--variance", type=float, default=1.0)
    ap.add_argument("--solver", default="cg-schur-coefmg")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (float64 unless --tpu)")
    ap.add_argument("--tpu", action="store_true",
                    help="float32, the original's accelerator setting")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; --cpu for the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--normalize", action="store_true",
                    help="exact marginal normalization of the SPDE field")
    ap.add_argument("--coarse-ops", default="galerkin",
                    choices=("galerkin", "rediscretize"))
    ap.add_argument("--flat-kinv", action="store_true",
                    help="replace the SPE10-like kinv_ref with 1 (isolates "
                    "the sampler/discretization effects from upscaling)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    grid = tuple(int(x) for x in args.grid.split(","))
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg = ProblemConfig(
        mesh="box",
        ncells=tuple(g // 2 ** (args.nlevels - 1) for g in grid),
        lengths=lengths,
        refinements=args.nlevels - 1,
        correlation_length=args.corlen,
        variance=args.variance,
        dtype="float32" if args.tpu else "float64",
        seed=args.seed,
    )
    cfg.darcy_solver.name = args.solver
    cfg.darcy_solver.relative_tolerance = args.rtol
    cfg.darcy_solver.max_iterations = 800
    cfg.normalize_marginals = args.normalize
    cfg.coarse_operators = args.coarse_ops
    kinv = None if args.flat_kinv else load_spe10_kinv(None, ncells=grid)
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    sampler, solver, hier = prob.sampler, prob.solver, prob.hierarchy

    key = PRNGKey(args.seed)
    nl = cfg.nlevels
    print(f"# grid {grid}, levels {[hier.levels[l].mesh.shape for l in range(nl)]}")
    print(f"# dofs {[solver.num_dofs(l) for l in range(nl)]}")

    for level in range(nl - 1):
        qs_f, qs_c, qs_x = [], [], []
        corr_w = []
        bs = 16
        nb = -(-args.n // bs)
        parent = torch.as_tensor(np.asarray(hier.parent[level]), dtype=torch.int64,
                                 device=device)
        for b in range(nb):
            k = fold_in(fold_in(key, level), b)
            xi = sampler.sample(level, k, bs)
            w_f = sampler.eval(level, xi)
            w_c = sampler.eval(level + 1, xi, xi_level=level)
            # fine-level field = prolongated coarse field
            w_x = torch.index_select(w_c, -1, parent)
            q_f, _, info_f = solver.solve_fwd(level, w_f)
            q_c, _, info_c = solver.solve_fwd(level + 1, w_c)
            q_x, _, info_x = solver.solve_fwd(level, w_x)
            for acc, q in ((qs_f, q_f), (qs_c, q_c), (qs_x, q_x)):
                acc.append(host(q).astype(np.float64))
            lf = np.log(host(w_f))
            lc = np.log(host(w_x))
            corr_w.append(
                np.mean(
                    [
                        np.corrcoef(lf[i], lc[i])[0, 1]
                        for i in range(lf.shape[0])
                    ]
                )
            )
            if b == 0:
                print(
                    f"# level {level}: iters f/c/x = "
                    f"{int(info_f.iterations)}/{int(info_c.iterations)}/{int(info_x.iterations)}"
                    f" converged {bool(info_f.converged.all())}/{bool(info_c.converged.all())}/{bool(info_x.converged.all())}"
                )
        q_f = np.concatenate(qs_f)
        q_c = np.concatenate(qs_c)
        q_x = np.concatenate(qs_x)
        y = q_f - q_c
        y_field = q_f - q_x
        y_disc = q_x - q_c
        print(f"== level pair ({level},{level + 1}), n={q_f.size} ==")
        print(f"  E[Q_f]={q_f.mean():.4g}  E[Q_c]={q_c.mean():.4g}  E[Q_x]={q_x.mean():.4g}")
        print(f"  Var[Q_f]={q_f.var():.4g}  Var[Q_c]={q_c.var():.4g}")
        print(f"  E[Y]={y.mean():.4g}      Var[Y]={y.var():.4g}      corr(Qf,Qc)={np.corrcoef(q_f, q_c)[0, 1]:.4f}")
        print(f"  E[Y_field]={y_field.mean():.4g}  Var[Y_field]={y_field.var():.4g}  (sampler field mismatch)")
        print(f"  E[Y_disc]={y_disc.mean():.4g}   Var[Y_disc]={y_disc.var():.4g}   (discretization+upscaling)")
        print(f"  mean corr(log w_f, log P w_c) = {np.mean(corr_w):.4f}")


if __name__ == "__main__":
    main()
