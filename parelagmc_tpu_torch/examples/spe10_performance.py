"""SPE10-scale MLMC performance harness with captured JSON evidence. Twin of
examples/spe10_performance.py.

Reference analog: examples/SPE10/SPE10_PDESampler_Performance.cpp:165-185 -
time nsamples of (Sample + Eval [+ Darcy forward]) per level and print the
per-level dofs / iterations / sec-per-sample table. This harness also runs
the MLMC coupled pair step per level (the estimator's real hot loop) and
writes everything to a JSON file (default SPE10_EVIDENCE_TORCH.json, never
the JAX package's SPE10_EVIDENCE.json) with the device it ran on.

Timing: every measured call draws its own key (fold_in of the seed key, the
original's keys, so both packages draw the same samples), and its result is
copied to the host, which waits for the card. `compile_sec` keeps its key
and is the wall of the first (warm-up) call. Each timing is the best of 3
rounds.

Usage: python -m parelagmc_tpu_torch.examples.spe10_performance
       [--perm-file spe_perm.dat] [--out F.json] [--selfcheck]
       [--batch-clamp 512] [--darcy-solver cg-schur-coefmg]
       [--device cuda:0] [common options]
"""

import json
import sys
import time

import numpy as np
import torch

from parelagmc_tpu_torch.device import device_info
from parelagmc_tpu_torch.examples._evidence import host, masked_dinv, mean_of
from parelagmc_tpu_torch.examples.common import is_main, parse_args, report
from parelagmc_tpu_torch.examples.spe10_mlmc import take_flag, take_option
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem

DEFAULT_OUT = "SPE10_EVIDENCE_TORCH.json"


def _struct_vcycle_batch_selfcheck(solver, tol=1e-4):
    """Batch-consistency check of the structured coefMG: sample 0 of a
    batch-2 V-cycle, fine S-apply and coarse cycle must equal the batch-1
    run up to rounding. A batch-mixing fault leaves every op plausible alone
    while destroying convergence."""
    from parelagmc_tpu_torch.ops import coef_multigrid_structured as cms

    L = solver.levels[0]
    if not isinstance(getattr(L, "coef_mg", None), cms.StructCoefMG):
        report("-- selfcheck skipped (no structured coefMG at level 0)")
        return
    mg = L.coef_mg
    shape0 = mg.levels[0].shape
    rng = np.random.default_rng(0)
    n_c = int(np.prod(shape0))
    as_t = lambda a: torch.as_tensor(a, dtype=solver.dtype, device=solver.device)
    w2 = as_t(np.exp(rng.normal(size=(2, n_c)) * 0.7).astype(np.float32))
    p2 = as_t(rng.normal(size=(2, n_c)).astype(np.float32))

    def parts(ww, pp):
        # diag M(w) with essential faces 0, read off the mass tables as the
        # solver's own preconditioner does.
        st = cms.struct_mg_setup(mg, masked_dinv(L, ww))
        bg = pp.reshape(pp.shape[:-1] + tuple(shape0[::-1]))
        rc = cms._restrict_cells(bg, mg.levels[1]) if len(mg.levels) > 1 else bg
        return (
            cms.struct_v_cycle(mg, st, pp),
            cms.struct_s_apply(mg, st, pp),
            cms._v_cycle_grid(mg, st, rc, 2, 1) if len(mg.levels) > 1 else rc,
        )

    o1 = parts(w2[:1], p2[:1])
    o2 = parts(w2, p2)
    for name, a, b in zip(("v_cycle", "s_apply", "coarse_cycle"), o1, o2):
        a, b = host(a)[0], host(b)[0]
        dd = float(np.abs(a - b).max() / (np.abs(a).max() or 1.0))
        if dd > tol:
            raise RuntimeError(
                f"struct coefMG batch-consistency selfcheck FAILED on "
                f"'{name}': batch-2 sample 0 deviates rel {dd:.3e} from the "
                f"batch-1 run (ops/coef_multigrid_structured.py)"
            )
        report(f"-- selfcheck {name}: batch1-vs-batch2[0] rel diff {dd:.1e} ok")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    perm_file = take_option(argv, "--perm-file")
    out_file = take_option(argv, "--out") or DEFAULT_OUT
    selfcheck = take_flag(argv, "--selfcheck")
    # Coarse-level batch cap (level_batch below).
    batch_clamp = int(take_option(argv, "--batch-clamp") or 512)
    # Per-sample Galerkin MG (the static-kinv MG stalls at SPE10 contrast).
    darcy_solver = take_option(argv, "--darcy-solver") or "cg-schur-coefmg"
    cfg, device = parse_args(
        argv,
        mesh="spe10",
        refinements=2,
        correlation_length=100.0,
        initial_samples=64,
        batch_size=64,
        normalize_marginals=True,
        axis_order="auto",
    )
    cfg.darcy_solver.name = darcy_solver
    # The harness's solver settings, each yielding to an explicit
    # --solver-opt: 80 iterations per segment with up to `segments` warm
    # continuations; rtol 1e-5 (a 1e-4 residual leaves the plain flux QoI
    # far from the converged one at SPE10 contrast); local sqrt(w)-scaled
    # MG; cheb3 lo=0.10 smoothing with a bfloat16 preconditioner state (the
    # production tuning of examples/spe10_mlmc.py). The converged_fraction
    # column is the validity check of any capture with these on.
    user_opts = {
        argv[i + 1].partition("=")[0]
        for i, tok in enumerate(argv)
        if tok == "--solver-opt"
    }
    if "max_iterations" not in user_opts:
        cfg.darcy_solver.max_iterations = 80
    if "relative_tolerance" not in user_opts:
        cfg.darcy_solver.relative_tolerance = 1e-5
    if "local_schur_scaling" not in user_opts:
        cfg.darcy_solver.local_schur_scaling = True
    if "coefmg_cheby_order" not in user_opts:
        cfg.darcy_solver.coefmg_cheby_order = 3
    if "coefmg_cheby_lo" not in user_opts:
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
    if "coefmg_prec_dtype" not in user_opts:
        cfg.darcy_solver.coefmg_prec_dtype = "bfloat16"
    segments = 6
    kinv = load_spe10_kinv(perm_file, ncells=(60, 220, 85))
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    sampler, solver = prob.sampler, prob.solver

    if selfcheck:
        _struct_vcycle_batch_selfcheck(solver)
    key = PRNGKey(cfg.seed)
    dt_bytes = 4 if cfg.dtype == "float32" else 8

    def level_batch(level):
        """The reference's per-level batch schedule: 8 above 2M Darcy dofs
        (the finest SPE10 level holds ~4.5M), else a budget of 12e9 bytes
        over 40 live vectors of the level's dofs per sample, rounded down to
        a power of two and capped at --batch-clamp. Kept so that both
        packages time the same samples at the same batch."""
        if solver.num_dofs(level) > 2_000_000:
            return 8
        per_sample = 40 * solver.num_dofs(level) * dt_bytes
        cap = max(8, int(12e9 / per_sample))
        return min(batch_clamp, 1 << (cap.bit_length() - 1))

    def timed(step, label, batch, max_reps=None):
        reps = max(1, cfg.initial_samples // batch)
        if max_reps is not None:
            reps = min(reps, max_reps)
        else:
            reps = max(reps, 4)
        t0 = time.perf_counter()
        warm = step(fold_in(key, 987654))
        host(warm[0])
        compile_s = time.perf_counter() - t0
        dt, outs = np.inf, None
        for r in range(3):
            t0 = time.perf_counter()
            cur = [step(fold_in(key, 100 * r + 10 + i)) for i in range(reps)]
            _ = [host(o[0]) for o in cur]
            d = time.perf_counter() - t0
            if d < dt:
                dt, outs = d, cur
        n = reps * batch
        iters = mean_of([o[-1] for o in outs])
        # Steps returning (value, converged, iterations) also report the
        # converged fraction: an unconverged capture is not evidence.
        conv = mean_of([o[1] for o in outs]) if len(outs[0]) == 3 else None
        conv_txt = "" if conv is None else f" conv {conv * 100:.0f}%"
        report(
            f"  {label:28s} {dt / n * 1e3:10.3f} ms/sample "
            f"{n / dt:10.1f} samples/s  iters {iters:.0f}{conv_txt} "
            f"(compile {compile_s:.1f}s)"
        )
        if conv is not None and conv < 1.0:
            report(f"  !! {label}: only {conv * 100:.0f}% of samples "
                   f"converged - treat this capture as INVALID")
        out = {
            "sec_per_sample": dt / n,
            "samples_per_sec": n / dt,
            "mean_iterations": iters,
            "compile_sec": compile_s,
        }
        if conv is not None:
            out["converged_fraction"] = conv
        return out, warm

    evidence = {
        "config": {
            "mesh": "spe10 60x220x85 (20x10x2 ft)",
            "nlevels": cfg.nlevels,
            "batch": cfg.batch_size,
            "dtype": cfg.dtype,
            "correlation_length_ft": cfg.correlation_length,
            "darcy_solver": cfg.darcy_solver.name,
            "darcy_max_iterations": cfg.darcy_solver.max_iterations,
            "perm": "spe_perm.dat" if perm_file else "synthetic fallback",
        },
        "device": device_info(device),
        "levels": [],
    }
    report(f"-- SPE10 performance: {cfg.nlevels} levels, batch {cfg.batch_size}")
    for level in range(cfg.nlevels):
        batch = level_batch(level)
        row = {
            "level": level,
            "stoch_dofs": int(sampler.sample_size(level)),
            "darcy_dofs": int(solver.num_dofs(level)),
            "darcy_nnz": int(solver.nnz(level)),
            "batch": batch,
        }
        report(
            f"level {level}: sampler dofs {row['stoch_dofs']}, "
            f"darcy dofs {row['darcy_dofs']}, nnz {row['darcy_nnz']}, "
            f"batch {batch}"
        )

        # Sampler-only timing at the full batch (no Darcy memory pressure).
        se_batch = cfg.batch_size

        def sample_eval(k, level=level, batch=se_batch):
            s = sampler.eval(level, sampler.sample(level, k, batch))
            # Per-sample means: O(batch) numbers to the host, not the field.
            return torch.mean(s, dim=-1), torch.zeros((), device=s.device)

        row["sample_eval"], warm = timed(sample_eval, "Sample+Eval", se_batch)
        # The warm-up draw's field mean: a deterministic moment to compare
        # between runs and packages.
        row["sample_eval"]["field_mean"] = float(np.mean(host(warm[0]).astype(np.float64)))

        if level < cfg.nlevels - 1:
            # Coarse solve, then the warm-started fine solve, then up to
            # segments - 1 continuations from the fine iterate: a restarted
            # CG is not one long CG, so the segments shape the counts.

            def pair(k, level=level, batch=batch):
                xi = sampler.sample(level, k, batch)
                s_f = sampler.eval(level, xi)
                s_c = sampler.eval(level + 1, xi, xi_level=level)
                qc, _, i_c, p_c = solver.solve_fwd(level + 1, s_c, return_pressure=True)
                q, _, i_f, p = solver.solve_fwd_warm(level, s_f, p_c, return_pressure=True)
                conv, iters = i_f.converged, i_f.iterations + i_c.iterations
                for _ in range(segments - 1):
                    if bool(conv.all()):
                        break
                    q, _, i_f, p = solver.solve_fwd_x0(level, s_f, p, return_pressure=True)
                    conv, iters = i_f.converged, iters + i_f.iterations
                # The converged fraction covers BOTH solves: an unconverged
                # coarse solve corrupts Y = q - qc as surely as a fine one.
                return q - qc, conv & i_c.converged, iters

            # Two measured reps at level 0 bound the harness's runtime.
            row["mlmc_pair"], _ = timed(pair, "MLMC pair (coupled+Darcy)", batch,
                                        max_reps=2 if level == 0 else None)
        else:

            def single(k, level=level, batch=batch):
                s = sampler.eval(level, sampler.sample(level, k, batch))
                q, _, info = solver.solve_fwd(level, s)
                return q, info.converged, info.iterations

            row["mlmc_pair"], _ = timed(single, "coarsest Q (Darcy)", batch)
        evidence["levels"].append(row)

    if is_main():
        with open(out_file, "w") as f:
            json.dump(evidence, f, indent=1)
    report(f"wrote {out_file}")
    return evidence


if __name__ == "__main__":
    main()
