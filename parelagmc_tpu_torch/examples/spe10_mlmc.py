"""MLMC on the SPE10 benchmark: Darcy flow through the SPE10 permeability
field perturbed by a random log-normal multiplier sampled with the SPDE
sampler. Twin of examples/spe10_mlmc.py (reference analog:
examples/SPE10/SPE10_MLMC.cpp; permeability loading SPE10_MLMC.cpp:165-171 -
here physics/spe10.py, with a synthetic field when spe_perm.dat is absent).

Defaults are scaled down (--refinements 1, large corlen); pass
--refinements 2 and --perm-file data/spe_perm.dat for the full
configuration, which takes the production solver settings of
physics/spe10.full_grid_solver_defaults. --grid nx,ny,nz runs a box with the
SPE10 extents and the synthetic permeability instead of the 60x220x85 grid;
--adaptive runs the manager to the target MSE instead of one fixed-N round.
"""

import dataclasses
import sys

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.physics import spe10
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MLMCManager
from parelagmc_tpu_torch.utils.timing import TimeManager

# The drivers' settings before the command line (examples/spe10_mlmc.py):
# 100 ft correlation length on the 1200x2200x170 ft domain; exact per-cell
# marginal normalization of the SPDE field (--raw-marginals for reference
# statistical parity: the coarse SPE10 levels under-resolve the field, and
# the raw per-level marginal mismatch destroys the MLMC variance decay);
# the largest cell count as the x axis (--axis-order none to disable).
SPE10_DEFAULTS = dict(
    mesh="spe10",
    refinements=1,
    correlation_length=100.0,
    initial_samples=32,
    batch_size=32,
    normalize_marginals=True,
    axis_order="auto",
)


def take_flag(argv, name: str) -> bool:
    """Remove `name` from argv; whether it was there."""
    if name in argv:
        argv.remove(name)
        return True
    return False


def take_option(argv, name: str):
    """Remove `name VALUE` from argv; VALUE, or None."""
    if name not in argv:
        return None
    i = argv.index(name)
    value = argv[i + 1]
    del argv[i: i + 2]
    return value


def parse_grid(value):
    return tuple(int(x) for x in value.split(",")) if value is not None else None


def full_grid_solver_defaults(cfg, argv):
    """The full-grid (60x220x85) production solver settings
    (physics/spe10.full_grid_solver_defaults), each yielding to an explicit
    --solver-opt in `argv` that parse_args has already applied."""
    user_opts = {
        argv[i + 1].partition("=")[0]
        for i, tok in enumerate(argv)
        if tok == "--solver-opt"
    }
    return spe10.full_grid_solver_defaults(cfg, user_opts)


def spe10_grid(cfg, grid, perm_file, argv):
    """(config, kinv_ref): a box of `grid` cells with the SPE10 extents and
    the synthetic permeability, or the full 60x220x85 grid with the
    production solver settings (odd z-counts coarsen by merging the
    trailing layer into the last coarse cell)."""
    if grid is not None:
        lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
        f = 2 ** cfg.refinements
        cfg = dataclasses.replace(
            cfg, mesh="box", ncells=tuple(g // f for g in grid), lengths=lengths
        )
        return cfg, spe10.load_spe10_kinv(None, ncells=grid)
    kinv = spe10.load_spe10_kinv(perm_file, ncells=(60, 220, 85))
    full_grid_solver_defaults(cfg, argv)
    return cfg, kinv


def build_config(argv):
    """(config, device, kinv_ref, adaptive) of a command line."""
    argv = list(argv)
    adaptive = take_flag(argv, "--adaptive")
    perm_file = take_option(argv, "--perm-file")
    grid = parse_grid(take_option(argv, "--grid"))
    cfg, device = parse_args(argv, mse=-1.0, **SPE10_DEFAULTS)  # mse -1: auto-MSE
    cfg, kinv = spe10_grid(cfg, grid, perm_file, argv)
    return cfg, device, kinv, adaptive


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device, kinv, adaptive = build_config(argv)
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    if adaptive:
        # The reference's headline mode (MLMC_Manager::Run,
        # MLMC_Manager.cpp:181-214): initial samples estimate the rates,
        # then compute_nsamples_mse drives per-level N_l from the measured
        # V_l / C_l until ml_estimator_variance <= ratio * eps2.
        est = mgr.run()
        print(
            f"-- adaptive: estimate {est:.6g}, target eps2 {mgr.eps2:.6g}, "
            f"actual MSE {mgr.actual_mse:.6g} "
            f"(sampling var {mgr.ml_estimator_variance:.6g} <= "
            f"{mgr.ratio:.2f}*eps2 = {mgr.ratio * mgr.eps2:.6g}), "
            f"N_l = {list(mgr.level_nsamples)}"
        )
    else:
        mgr.init_run([cfg.initial_samples] * cfg.nlevels)
    print(mgr.show_me())
    TimeManager.print_table()
    mgr.close()
    return mgr


if __name__ == "__main__":
    main()
