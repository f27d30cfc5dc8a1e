"""Split SPE10 MLMC Var[Y_l] into solver noise and field/discretization
physics by a PAIRED tolerance A/B. Twin of examples/spe10_beta_noise.py.

Runs the production estimator (the port's spe10_mlmc driver) twice on the
IDENTICAL sample stream (same seed, counter-based keys - solver settings do
not touch sampling):

  A (prod): adjoint-corrected QoI at the production rtol (1e-4)
  B (deep): adjoint-corrected QoI at --deep-rtol (1e-6)

and pairs the per-sample .dat logs row by row. For each level:

  Var[Y_A]          what the estimator sees in production
  Var[Y_B]          the (near) solver-noise-free variance
  Var[Y_A - Y_B]    the solver-noise POWER in the production capture - a
                    paired measurement, so it resolves noise far below the
                    sampling error of an unpaired variance comparison

If Var[Y_A - Y_B] << Var[Y_B], the production Var[Y_0] (and hence beta) is
discretization/field physics, not residual noise, and tightening
tolerances cannot raise beta. Reference rate economics this informs:
src/MLMC_Manager.cpp:333-398 of the reference. A deep-leg level whose mean
iterations sit at the budget ceiling is unconverged noise, not a variance
measurement: the report records mean iterations per level and leg.

Devices: `--cpu-f64` runs both legs on the CPU in float64 with the explicit
production solver family and a 600-iteration budget (the original's
meaning); without it they run on --device (default cuda:0) at the driver's
own dtype, and raise without a card. The .dat logs go to the working
directory (beta_prod.dat, beta_deep.dat).

Usage: python -m parelagmc_tpu_torch.examples.spe10_beta_noise
        [--samples 256] [--deep-rtol 1e-6] [--cpu-f64] [--grid 32,64,16]
        [--device cuda:0] [spe10_mlmc options]
Writes SPE10_BETA_NOISE_TORCH.json (or SPE10_BETA_NOISE_F64_TORCH.json).
"""

import json
import sys

import numpy as np

from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples import spe10_mlmc
from parelagmc_tpu_torch.utils.regression import exp_weighted_regression


def _load_dat(path):
    rows = np.loadtxt(path, skiprows=1)
    out = {}
    for lvl in np.unique(rows[:, 0]).astype(int):
        sel = rows[rows[:, 0] == lvl]
        out[int(lvl)] = {"Y": sel[:, 1], "Q": sel[:, 2], "Qc": sel[:, 3]}
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def _pop(flag, default, cast):
        if flag in argv:
            i = argv.index(flag)
            v = cast(argv[i + 1])
            del argv[i: i + 2]
            return v
        return default

    n = _pop("--samples", 256, int)
    deep_rtol = _pop("--deep-rtol", 1e-6, float)
    cpu_f64 = spe10_mlmc.take_flag(argv, "--cpu-f64")
    # Resolved before any work: without a card and without --cpu-f64 this
    # raises here.
    device = resolve_device("cpu" if cpu_f64 else _pop("--device", None, str))

    common = ["--refinements", "2", "--mse", "1e10", "--samples", str(n),
              "--device", str(device)]
    legs = {
        "prod": [],
        "deep": ["--solver-opt", f"relative_tolerance={deep_rtol}"],
    }
    if cpu_f64:
        # The production solver family, explicit, so that scaled --grid runs
        # (which skip full_grid_solver_defaults) still compare it; and an
        # honest converging budget for the deep leg.
        common += ["--dtype", "float64",
                   "--solver-opt", "name=cg-schur-coefmg",
                   "--solver-opt", "adjoint_qoi=true",
                   "--solver-opt", "max_iterations=600"]
        legs["prod"] = ["--solver-opt", "relative_tolerance=1e-4"]

    out_json = "SPE10_BETA_NOISE_F64_TORCH.json" if cpu_f64 else "SPE10_BETA_NOISE_TORCH.json"
    mgrs = {}
    for tag, extra in legs.items():
        print(f"== running {tag} leg ({n} samples/level) ==", flush=True)
        mgrs[tag] = spe10_mlmc.main(
            common + ["--output", f"beta_{tag}.dat"] + extra + argv
        )

    a = _load_dat("beta_prod.dat")
    b = _load_dat("beta_deep.dat")
    report = {
        "samples_per_level": n,
        "deep_rtol": deep_rtol,
        "cpu_f64": cpu_f64,
        "device": device_info(device),
        "levels": [],
    }
    iters = {tag: np.asarray(m.solver_iterations) for tag, m in mgrs.items()}
    for lvl in sorted(a):
        ya, yb = a[lvl]["Y"], b[lvl]["Y"]
        m = min(ya.size, yb.size)
        ya, yb = ya[:m], yb[:m]
        d = ya - yb
        lv = {
            "level": lvl,
            "n": int(m),
            "var_Y_prod": float(ya.var(ddof=1)),
            "var_Y_deep": float(yb.var(ddof=1)),
            "var_noise": float(d.var(ddof=1)),
            "noise_fraction_of_var": float(d.var(ddof=1) / yb.var(ddof=1)),
            "mean_Y_prod": float(ya.mean()),
            "mean_Y_deep": float(yb.mean()),
            "max_abs_dY": float(np.abs(d).max()),
            "corr": float(np.corrcoef(ya, yb)[0, 1]),
            "mean_iters_prod": float(iters["prod"][lvl]),
            "mean_iters_deep": float(iters["deep"][lvl]),
        }
        report["levels"].append(lv)
        print(
            f"level {lvl}: Var[Y] prod {lv['var_Y_prod']:.4g} / deep "
            f"{lv['var_Y_deep']:.4g}, paired noise power "
            f"{lv['var_noise']:.4g} ({100 * lv['noise_fraction_of_var']:.2f}% "
            f"of deep Var), corr {lv['corr']:.6f}, iters "
            f"{lv['mean_iters_prod']:.1f}/{lv['mean_iters_deep']:.1f}"
        )

    # Beta from the deep (noise-free) leg and from the production leg over
    # the Y-pair levels (the coarsest level is plain MC, not a Y), with the
    # level dof counts of the BUILT hierarchy, so that --grid and
    # --refinements stay consistent.
    mgr = mgrs["prod"]
    pair = [lv for lv in report["levels"] if lv["level"] < mgr.nlevels - 1]
    if len(pair) >= 2:
        M = np.asarray(mgr.M)[[lv["level"] for lv in pair]]
        report["M_pair_levels"] = [float(x) for x in M]
        report["beta_prod"] = float(exp_weighted_regression(
            np.array([lv["var_Y_prod"] for lv in pair]), M, 0))
        report["beta_deep"] = float(exp_weighted_regression(
            np.array([lv["var_Y_deep"] for lv in pair]), M, 0))
        print(f"beta (pair levels): prod {report['beta_prod']:.3f}, "
              f"deep {report['beta_deep']:.3f}")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)
    print(f"written: {out_json}")
    return report


if __name__ == "__main__":
    main()
