#!/usr/bin/env python3
"""Where the time of the port's MLMC pair step and ratio step goes, on one
CUDA card.

Run from the root of a checkout:
    python3 profile_pair_step.py [--out FILE] [--configs bench,64^3,spe10,stacked,ratio]
    python3 profile_pair_step.py --k1 [ROOT]     (kernel K1 alone, see below)

Five configurations, steps chip_smoke.py times:
  bench  golden levels 0/1 with bench.py's settings: batch 512, float32,
         rtol 1e-4, 50 iterations, local Schur scaling;
  64^3   refinements=4 (64^3 against 32^3), batch 64, float64, local
         scaling, capped at 100 iterations per solve (a full solve takes
         600-1000; the cap keeps the profile short, and the per-iteration
         cost is what the split measures);
  spe10  the full 60x220x85 SPE10 grid, levels 0/1, with the production
         settings (cg-schur-coefmg with a bf16 cheb3 V-cycle, adjoint QoI,
         mean-field x0, float32, batch 8; synthetic permeability);
  stacked  the spe10 step with adjoint_stacked: each member's primal and
         adjoint systems solved as one CG over a right-hand-side axis, so
         that every iteration reads the sample's mass tables and
         preconditioner state once for both. minv_apply and prec_apply
         take two right-hand sides per sample (K1 with R = 2); the
         iteration counts are operator applications (2 x the loop's trips),
         as the sequential solves' primal + adjoint sums are, so the
         per-iteration rows of spe10 and stacked compare like with like;
  ratio  the same problem's level-0 step of BayesRatioManager at batch 8:
         two independent noise streams (Z and R), each evaluated on levels
         0 and 1, and four cold solves (mean-field x0, no coarse warm
         start), each with its pressure read for the likelihood. Its rows:
         noise is both draws, sampler_solve one stream's two evaluations,
         coarse_solve and fine_solve one cold solve with the pressure
         returned on level 1 and level 0, pair_step the whole ratio step.

For each it measures the layers of one pair step:
  noise          SPDESampler.sample of the level-0 noise (K2)
  sampler_solve  SPDESampler.eval on the fine and the coarse level
  coarse_solve   DarcySolver.solve_fwd on the coarse level
  fine_solve     DarcySolver.solve_fwd_warm on the fine level
  minv_apply     one M(w)^{-1} apply on the fine level (three K1 launches)
  prec_apply     one coefMG V-cycle on the fine level (spe10 only)
  pair_step      the whole step
and for each layer: host wall ms per call (synchronized, no profiler),
event ms per call (CUDA events around back-to-back calls, no profiler: an
upper bound on device time, idle gaps included), device ms per call
(torch.profiler, the sum of the kernels' times; a lower bound if the
profiler drops events), kernels per call, and busy = device / wall
(1 - busy is the device's idle share).
For the whole step it also splits device time by the operator that
launched each kernel. One line per layer on stdout; the whole report as
JSON to --out. Exits non-zero without a CUDA card.

--k1 [ROOT] times kernel K1 alone, from the package under ROOT (an absolute
path; default this checkout) and prints one line of CUDA-event ms per call:
`thomas` on (n, L) line tables (110 x 161 280 and 42 x 422 400, the coefMG
smoother's shapes on the SPE10 level-1 grid at batch 128) in float32,
bfloat16 and float64; `thomas` with R right-hand sides per table set on
static (n, L) tables (K1_SHARED_TABLES: the static multigrid's line
smoothers on the SPE10 grids at the production batches); and M(w)^{-1}
(`apply_factored`) on boxes of the sizes of the SPE10 level-0 and level-1
grids and of the 64^3 box, with one and with two vectors per sample. To
compare two trees on one card, unpack the other with `git archive` into a
git-ignored directory and run them in turns in one call: parent, change,
change, parent. Each process builds the kernels of its own tree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILER_ATTEMPTS = 3  # sessions tried before a layer is reported without device time
# (substring of a device function's name, key of the device split): K1 has
# two device functions in csrc/thomas.cu, the Thomas path for strided rows
# and the segment path for contiguous rows; K2/K3 share one.
KERNEL_TAGS = (("line_solve_kernel", "K1 thomas"), ("segment_solve_kernel", "K1 thomas"),
               ("threefry_kernel", "K2/K3 threefry"), ("coefmg_", "coefMG stencil"))
# --k1: (n, L) of the single-vector line tables; (n, L, R, dtypes) of the
# tables shared by R right-hand sides; (cells, batch, dtypes) of M(w)^{-1}.
K1_LINE_TABLES = ((110, 161280), (42, 422400))
K1_SHARED_TABLES = ((110, 1260, 128, ("float32", "bfloat16", "float64")),
                    (42, 3300, 128, ("float32",)), (220, 5100, 8, ("float32",)),
                    (55, 315, 512, ("float32",)), (110, 1260, 3, ("float32",)))
K1_BOXES = (((220, 60, 85), 8, ("float32",)), ((110, 30, 42), 128, ("float32",)),
            ((64, 64, 64), 64, ("float32", "float64")))


def time_k1(root: str) -> None:
    """The --k1 mode: one line of K1's times from the package under root."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import parelagmc_tpu_torch
    from parelagmc_tpu_torch.fem import build_mixed_level
    from parelagmc_tpu_torch.mesh import make_box_mesh
    from parelagmc_tpu_torch.ops.mass_solve import build_mass_tridiag_solver
    from parelagmc_tpu_torch.ops.tridiag_pallas import thomas

    if not parelagmc_tpu_torch.__file__.startswith(root + os.sep):
        sys.exit(f"profile_pair_step: imported {parelagmc_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        sys.exit("profile_pair_step: torch.cuda.is_available() is False: needs a CUDA card")
    dev = torch.device("cuda")

    def ms(fn, reps: int = 50) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = []
    g = torch.Generator(device="cuda").manual_seed(0)

    def tables(n, L, dt, rhs=()):
        dl = torch.rand(n, L, generator=g, device=dev) * 0.9 + 0.1
        du = torch.rand(n, L, generator=g, device=dev) * 0.9 + 0.1
        b = torch.randn(*rhs, n, L, generator=g, device=dev)
        return [x.to(dt).contiguous() for x in (dl, dl + du + 1.0, du, b)]

    for n, L in K1_LINE_TABLES:
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            t = tables(n, L, dt)
            out.append((f"lines n{n} {str(dt)[6:]}", ms(lambda: thomas(*t))))
    for n, L, R, dtypes in K1_SHARED_TABLES:
        for name in dtypes:
            t = tables(n, L, getattr(torch, name), (R,))
            out.append((f"shared n{n} L{L} R{R} {name}", ms(lambda: thomas(*t))))
    for shape, batch, dtypes in K1_BOXES:
        lvl = build_mixed_level(make_box_mesh(shape))
        ess = lvl.ess_faces(np.array([0, 1, 1, 1, 1, 0]))
        for name in dtypes:
            dt = getattr(torch, name)
            solver = build_mass_tridiag_solver(lvl, ess, dtype=dt, device=dev)
            fac = solver.factor(torch.rand(batch, lvl.n_s, generator=g, device=dev, dtype=dt) + 0.5)
            for R in (1, 2):
                r = torch.randn((batch,) + (R,) * (R > 1) + (lvl.n_u,), generator=g, device=dev,
                                dtype=dt)
                out.append((f"minv {shape} b{batch} R{R} {name}",
                            ms(lambda: solver.apply_factored(fac, r))))
            del solver, fac, r
            torch.cuda.empty_cache()
    gpu = torch.cuda.get_device_name(0)
    print(f"{os.path.basename(root)} [{gpu}] " + " ".join(f"{k}={v:.4f}" for k, v in out),
          flush=True)


def measure(fn, reps: int):
    """(row, key_averages) for fn: wall ms (median of reps synchronized
    calls), event ms, device ms, kernels per call, busy share. A profiler session
    that records no device event at all is run again, up to
    PROFILER_ATTEMPTS sessions; if none records any, the device fields are None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[len(walls) // 2]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    row = {"wall_ms": wall, "event_ms": start.elapsed_time(end) / reps, "device_ms": None,
           "busy": None, "kernels": None, "profiler_sessions": 0}
    for _ in range(PROFILER_ATTEMPTS):
        row["profiler_sessions"] += 1
        # One discarded warm-up step before the recorded one: without it the
        # first device events of a session can be lost.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ka = prof.key_averages()
        kern = [e for e in ka if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        device = sum(e.self_device_time_total for e in kern) / 1e3 / reps
        if device > 0.0:
            row.update(device_ms=device, busy=device / wall,
                       kernels=sum(e.count for e in kern) / reps)
            break
        print("profile_pair_step: a profiler session recorded no device event",
              file=sys.stderr, flush=True)
    return row, ka


def device_split(ka, reps: int) -> dict:
    """Device ms per call by the aten operator that launched each kernel;
    the port's own kernels (launched outside aten) under their kernel's
    name, all of K1's device functions summed under one key."""
    from torch.autograd import DeviceType

    split = {}
    for e in ka:
        if e.device_type == DeviceType.CPU and e.key.startswith("aten::") \
                and e.self_device_time_total > 0:
            split[e.key] = e.self_device_time_total / 1e3 / reps
        elif e.device_type == DeviceType.CUDA:
            for tag, name in KERNEL_TAGS:
                if tag in e.key:
                    split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def ratio_layers(prob, batch: int, key, s_f, s_c):
    """(layers, iterations) of the level-0 ratio step: the manager's own
    step, and its cold solves one by one."""
    from parelagmc_tpu_torch.ops.prng import split
    from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager

    sampler, solver = prob.sampler, prob.solver
    bip = BayesianInverseProblem(solver, sampler, prob.config, prob.dtype)
    bip.generate_observational_data()
    mgr = BayesRatioManager(bip, prob.config)
    if mgr.level_batch[0] != batch:
        raise ValueError(f"ratio step batch {mgr.level_batch[0]} != {batch}")
    step, budget = mgr._step(0), mgr.solve_budget
    kz, kr = split(key)
    cold = lambda level, w: solver.solve_fwd(level, w, return_pressure=True, max_iters=budget)
    layers = {
        "noise": lambda: (sampler.sample(0, kz, batch), sampler.sample(0, kr, batch)),
        "coarse_solve": lambda: cold(1, s_c),
        "fine_solve": lambda: cold(0, s_f),
        "pair_step": lambda: step(key),
    }
    its = {"coarse": int(cold(1, s_c)[2].iterations), "fine": int(cold(0, s_f)[2].iterations)}
    return layers, its


def profile_config(label: str, prob, batch: int, reps: int, gpu: str,
                   ratio: bool = False, stacked: bool = False) -> dict:
    import dataclasses

    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    sampler, solver = prob.sampler, prob.solver
    # The solver reads its options at each solve; the cached mean-field
    # iterates serve both adjoint modes.
    solver.solver_cfg = dataclasses.replace(solver.solver_cfg, adjoint_stacked=stacked)
    key = fold_in(PRNGKey(0), 7)
    xi = sampler.sample(0, key, batch)
    s_f = sampler.eval(0, xi)
    s_c = sampler.eval(1, xi, xi_level=0)
    # The pair's two solves as solve_fwd_pair runs them (with adjoint_qoi
    # the coarse adjoint warm-starts the fine one).
    adj = solver.adjoint_pair_enabled(0)
    out_c = solver.solve_fwd(1, s_c, return_pressure=True, return_adjoint=adj)
    info_c, p_c, lam_c = out_c[2], out_c[3], (out_c[4] if adj else None)
    _, _, info_f = solver.solve_fwd_warm(0, s_f, p_c, lam_c=lam_c)
    L0 = solver.levels[0]
    fac = L0.mass_solver.factor(s_f)
    rhs = (2,) if stacked else ()  # right-hand sides per sample at axis -2
    u = s_f.new_ones((batch,) + rhs + (L0.n_u,))

    def pair_step():
        x = sampler.sample(0, key, batch)
        solver.solve_fwd_pair(0, sampler.eval(0, x), sampler.eval(1, x, xi_level=0))

    layers = {
        "noise": lambda: sampler.sample(0, key, batch),
        "sampler_solve": lambda: (sampler.eval(0, xi), sampler.eval(1, xi, xi_level=0)),
        "coarse_solve": lambda: solver.solve_fwd(1, s_c, return_pressure=True,
                                                 return_adjoint=adj),
        "fine_solve": lambda: solver.solve_fwd_warm(0, s_f, p_c, lam_c=lam_c),
        "minv_apply": lambda: L0.mass_solver.apply_factored(fac, u),
    }
    if L0.coef_mg is not None:
        # This sample's V-cycle (its state broadcast over the stacked axis).
        prec = solver._preconditioner(L0, s_f.unsqueeze(-2) if stacked else s_f, fac)
        r = s_f.new_ones((batch,) + rhs + (L0.n_s,))
        layers["prec_apply"] = lambda: prec(r)
    layers["pair_step"] = pair_step
    its = {"coarse": int(info_c.iterations), "fine": int(info_f.iterations)}
    if ratio:
        over, its = ratio_layers(prob, batch, key, s_f, s_c)
        layers.update(over)
    out = {"config": label, "batch": batch, "card": gpu, "iterations": its, "layers": {}}
    cheap = ("noise", "sampler_solve", "minv_apply", "prec_apply")
    for name, fn in layers.items():
        # A profiler session can lose a few device events; the cheap layers
        # run ten times as often so that a loss stays a small share.
        row, ka = measure(fn, 10 * reps if name in cheap else reps)
        out["layers"][name] = row
        if row["device_ms"] is None:
            print(f"{label} {name}: wall {row['wall_ms']:.3f} ms device not recorded in "
                  f"{row['profiler_sessions']} profiler sessions [{gpu}]", flush=True)
            continue
        print(f"{label} {name}: wall {row['wall_ms']:.3f} ms events {row['event_ms']:.3f} ms "
              f"device {row['device_ms']:.3f} ms "
              f"busy {100 * row['busy']:.1f}% kernels {row['kernels']:.0f} "
              f"(profiler sessions {row['profiler_sessions']}) [{gpu}]", flush=True)
        if name == "pair_step":
            out["pair_step_device_split_ms"] = device_split(ka, reps)
    it = out["iterations"]
    for name in ("coarse", "fine"):
        row = out["layers"][f"{name}_solve"]
        if row["device_ms"] is not None:
            row["device_ms_per_iteration"] = row["device_ms"] / max(it[name], 1)
            row["kernels_per_iteration"] = row["kernels"] / max(it[name], 1)
    split = out.get("pair_step_device_split_ms")
    if split:
        total = out["layers"]["pair_step"]["device_ms"]
        print(f"{label} iterations (coarse, fine) ({it['coarse']}, {it['fine']}); pair-step "
              "device split " + ", ".join(f"{k} {100 * v / total:.1f}%"
                                          for k, v in list(split.items())[:10])
              + f" [{gpu}]", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="write the report as JSON to this file")
    ap.add_argument("--configs", default="bench,64^3,spe10,stacked,ratio",
                    help="comma-separated configurations to profile")
    ap.add_argument("--k1", nargs="?", const=HERE, default="", metavar="ROOT",
                    help="time kernel K1 alone from the package under ROOT and exit")
    args = ap.parse_args()
    if args.k1:
        if not os.path.isabs(args.k1):
            sys.exit("profile_pair_step: --k1 takes an absolute path")
        return time_k1(args.k1.rstrip(os.sep))
    wanted = args.configs.split(",")
    unknown = sorted(set(wanted) - {"bench", "64^3", "spe10", "stacked", "ratio"})
    if unknown:
        sys.exit(f"profile_pair_step: unknown configurations {unknown}")
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_pair_step: torch.cuda.is_available() is False: needs a CUDA card")
    sys.path.insert(0, HERE)
    from chip_smoke import gpu_info, jax_modules_loaded, pair_problem, spe10_full_problem
    from parelagmc_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    gpu = gpu_info()
    kernels.library()
    configs = []
    if "bench" in wanted:
        configs.append(profile_config(
            "bench", pair_problem(2, 512, 1e-4, 50, "float32", device), 512, 5, gpu))
    if "64^3" in wanted:
        configs.append(profile_config(
            "64^3", pair_problem(4, 64, 1e-5, 100, "float64", device, restart_every=0),
            64, 2, gpu))
    if {"spe10", "stacked", "ratio"} & set(wanted):
        spe10 = spe10_full_problem(device)
        if "spe10" in wanted:
            configs.append(profile_config("spe10", spe10, 8, 3, gpu))
        if "stacked" in wanted:
            configs.append(profile_config("stacked", spe10, 8, 3, gpu, stacked=True))
        if "ratio" in wanted:
            configs.append(profile_config("ratio", spe10, 8, 3, gpu, ratio=True))
    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "configs": configs}
    if jax_modules_loaded():
        sys.exit(f"profile_pair_step: imported {jax_modules_loaded()}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    missing = [f"{c['config']} {name}" for c in report["configs"]
               for name, row in c["layers"].items() if row["device_ms"] is None]
    if missing:
        sys.exit(f"profile_pair_step: no device time recorded for {missing}")


if __name__ == "__main__":
    main()
