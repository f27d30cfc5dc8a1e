"""Bayesian ratio MLMC on SPE10 subsurface flow. Twin of
examples/spe10_ratio_mlmc.py.

Reference analog: examples/RatioEstimator_MLMC_Manager.cpp driving
ML_BayesRatio(_Splitting)_Manager (src/ML_BayesRatio_Manager.hpp:314-573)
with the SPDE prior and the Darcy likelihood on the SPE10 benchmark.

Posterior setup: three "well" pressure observations at mid-depth along the
long (y) axis of the 1200x2200x170 ft domain, local averages of radius
30 ft (widened on scaled grids to keep a cell center in range), synthetic
data y = G(u_ref) + N(0, noise) from one prior draw. Estimators: E[R]/E[Z]
and, with --splitting, E[R/Z]. The likelihood's solves run the primal to
PRESSURE_RTOL (uq/bayes.py's `pressure_rtol`), where the configuration's
tolerance is looser: the adjoint correction makes Q accurate, not the
pressure G reads.

Full-grid runs (default) take the production solver settings of
spe10_mlmc. --grid nx,ny,nz runs a box with the SPE10 extents (synthetic
permeability). Writes --out (default SPE10_RATIO_EVIDENCE.json): posterior
estimate, N_l, C_l, the per-level solver convergence canary, show_me().

Run: python -m parelagmc_tpu_torch.examples.spe10_ratio_mlmc --refinements 2 --samples 64
"""

import dataclasses
import json
import sys

import torch

from parelagmc_tpu_torch.examples.common import is_main, parse_args, report
from parelagmc_tpu_torch.examples.spe10_mlmc import (
    SPE10_DEFAULTS,
    parse_grid,
    spe10_grid,
    take_flag,
    take_option,
)
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager
from parelagmc_tpu_torch.utils import trace
from parelagmc_tpu_torch.utils.timing import TimeManager

# Mid-depth "wells" along the long axis (ft); local-average radius 30 ft
# covers a 3x6x30-cell box at the 20x10x2 ft SPE10 spacing.
OBS_COORDS = (300.0, 550.0, 85.0, 600.0, 1100.0, 85.0, 900.0, 1650.0, 85.0)
OBS_EPS = 30.0
# The primal tolerance of the likelihood's solves, measured on the full
# grid in float32: the loosest whose likelihoods sit well inside the
# benchmark's limit. It is near float32's floor there: about 1 solve in
# 5000 ends with its true residual above 4x it and counts as unconverged,
# its likelihood still within 1e-4 in log
# (benchmark/configs/spe10-bayes.json, PERF.md).
PRESSURE_RTOL = 3e-7


def with_wells(cfg, grid=None):
    """The config with the three wells as its observations: radius 30 ft on
    the real grid, at least 0.75 of the largest cell side of `grid`."""
    lengths_ft = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    gcells = grid if grid is not None else SPE10_NCELLS
    eps = max(OBS_EPS, 0.75 * max(L / n for L, n in zip(lengths_ft, gcells)))
    return dataclasses.replace(
        cfg,
        bayes_num_obs=3,
        bayes_obs_coords=OBS_COORDS,
        bayes_eps=eps,
        bayes_generate_ref_data=True,
        bayes_ref_data_file="",  # synthetic per run (deterministic seed)
    )


def build_config(argv):
    """(config, device, kinv_ref, options) of a command line; options holds
    splitting, adaptive, out, grid and perm_file."""
    argv = list(argv)
    opts = dict(splitting=take_flag(argv, "--splitting"),
                adaptive=take_flag(argv, "--adaptive"),
                perm_file=take_option(argv, "--perm-file"),
                grid=parse_grid(take_option(argv, "--grid")),
                out=take_option(argv, "--out") or "SPE10_RATIO_EVIDENCE.json")
    # Fixed-N evidence mode by default; --adaptive targets the MSE.
    cfg, device = parse_args(argv, mse=1e10, **SPE10_DEFAULTS)
    cfg = with_wells(cfg, opts["grid"])
    cfg, kinv = spe10_grid(cfg, opts["grid"], opts["perm_file"], argv)
    return cfg, device, kinv, opts


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device, kinv, opts = build_config(argv)
    splitting, adaptive, grid = opts["splitting"], opts["adaptive"], opts["grid"]
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    cfg = prob.config  # axis permutation applied (incl. obs coords)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype,
                                 pressure_rtol=PRESSURE_RTOL)
    bip.generate_observational_data()
    report(f"-- observational data y = {bip.G_obs.detach().cpu().numpy()}")

    # Solver convergence canary on the likelihood's solves, which the Z/R
    # streams run (the ratio steps do not surface SolveInfo; an unconverged
    # level is not evidence), with the iterations run past the
    # configuration's tolerance (on standard error).
    canary = []
    extra = trace.counters("krylov")
    for level in range(cfg.nlevels):
        xi = prob.sampler.sample(level, PRNGKey(99 + level), 8)
        w = prob.sampler.eval(level, xi)
        n0 = extra["extra_iterations"]
        _, _, _, info = bip.compute_G(level, w, return_info=True)
        canary.append({
            "level": level,
            "converged_fraction": float(info.converged.double().mean()),
            "mean_iterations": float(torch.as_tensor(info.iterations, dtype=torch.float64).mean()),
            "extra_iterations": extra["extra_iterations"] - n0,
        })
        report(f"-- canary L{level}: conv "
               f"{canary[-1]['converged_fraction'] * 100:.0f}% "
               f"iters {canary[-1]['mean_iterations']:.0f}")
        report(f"-- canary L{level}: iterations past the configuration's tolerance "
               f"{canary[-1]['extra_iterations']}", file=sys.stderr)

    mgr = BayesRatioManager(bip, cfg, splitting=splitting)
    if adaptive:
        est = mgr.run()
    else:
        mgr.init_run([cfg.initial_samples] * cfg.nlevels)
        est = mgr.estimate
    kind = "ML_BayesRatio_Splitting" if splitting else "ML_BayesRatio"
    report(f"FINAL {kind}_Manager ERRORS")
    dash = mgr.show_me()
    report(dash)
    TimeManager.print_table()

    evidence = {
        "config": {
            "grid": list(grid) if grid else [60, 220, 85],
            "nlevels": cfg.nlevels,
            "estimator": "splitting" if splitting else "ratio",
            "adaptive": adaptive,
            "obs_coords_ft": list(OBS_COORDS),
            "obs_eps_ft": cfg.bayes_eps,
            "noise": cfg.bayes_noise,
            "pressure_rtol": PRESSURE_RTOL,
            "perm": "spe_perm.dat" if opts["perm_file"] else "synthetic fallback",
            "solver": cfg.darcy_solver.name,
        },
        "posterior_estimate": float(est),
        "obs_data": [float(x) for x in bip.G_obs.detach().cpu().numpy()],
        "N_l": [int(n) for n in mgr.level_nsamples],
        "C_l_sec_per_sample": [float(c) for c in mgr.cost],
        "solver_canary": canary,
        "show_me": dash,
    }
    if is_main():
        with open(opts["out"], "w") as f:
            json.dump(evidence, f, indent=1)
    report(f"written: {opts['out']}")
    mgr.close()
    return est, mgr


if __name__ == "__main__":
    main()
