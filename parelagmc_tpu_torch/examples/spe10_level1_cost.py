"""Per-stage cost of the SPE10 MLMC level-1 pair step. Twin of
examples/spe10_level1_cost.py.

Reproduces the production level-1 step (the full-grid settings of
spe10_mlmc: adjoint-corrected QoI, segments of max_iterations) stage by
stage with the solver's public calls and reports, per batch, each stage's
wall seconds, iterations and converged fraction:

* stage1 - sample and evaluate the field on both levels, then the cold
           coarse solve (mean-field start) with pressure and adjoint;
* cont_c - continuations of the coarse solve from its own iterates
           (solve_fwd_x0) while samples are unconverged, up to the
           configured solve_segments;
* stage2 - the fine solve warm-started from the coarse pressure and
           adjoint (solve_fwd_warm);
* cont_f - continuations of the fine solve.

Every stage is ONE segment of max_iterations (passed to each call), then
the batch total in ms/sample and E[Y] = E[Q_l - Q_{l+1}]. The mean-field
starts (one w = 1 solve per level, cached by the solver) are computed and
timed before the batches. Keys from PRNGKey(7), fold_in per batch: on the
CPU the same draws as the JAX package's.

Usage: python -m parelagmc_tpu_torch.examples.spe10_level1_cost
        [--batches 3] [--level 1] [--device cuda:0] [common options]
"""

import sys
import time

import numpy as np

from parelagmc_tpu_torch.device import device_info, synchronize
from parelagmc_tpu_torch.examples._evidence import host
from parelagmc_tpu_torch.examples.common import parse_args, report
from parelagmc_tpu_torch.examples.spe10_mlmc import full_grid_solver_defaults, take_option
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem


def stage_row(name: str, dt: float, it: int, conv) -> dict:
    """One stage's record: wall seconds, iterations, converged fraction."""
    return dict(stage=name, wall_s=dt, iterations=int(it),
                converged=float(np.mean(host(conv))))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    nbatches = int(take_option(argv, "--batches") or 3)
    level = int(take_option(argv, "--level") or 1)
    cfg, device = parse_args(
        argv,
        mesh="spe10",
        refinements=2,
        correlation_length=100.0,
        normalize_marginals=True,
        axis_order="auto",
    )
    kinv = load_spe10_kinv(None, ncells=(60, 220, 85))
    full_grid_solver_defaults(cfg, argv)
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    sampler, solver = prob.sampler, prob.solver
    batch = cfg.batch_size_per_level[level]
    segments = cfg.solve_segments
    maxit = cfg.darcy_solver.max_iterations
    info = device_info(device)
    report(f"device: {info}")
    report(
        f"-- level {level} pair, batch {batch}, segments {segments}, "
        f"maxit {maxit}, rtol {cfg.darcy_solver.relative_tolerance}, adjoint "
        f"{cfg.darcy_solver.adjoint_qoi}"
    )
    kw = dict(return_pressure=True, return_adjoint=True, max_iters=maxit)
    if cfg.darcy_solver.meanfield_x0:
        for lvl in (level + 1, level):
            t0 = time.perf_counter()
            solver._meanfield_start(lvl)
            synchronize(device)
            report(f"   mean-field start level {lvl}: {time.perf_counter() - t0:.1f}s")

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        synchronize(device)
        return res, time.perf_counter() - t0

    key = PRNGKey(7)
    out = {"device": info, "level": level, "batch": batch, "segments": segments,
           "max_iterations": maxit, "batches": []}
    tot_t, tot_n, tot_iters = 0.0, 0, 0.0
    for b in range(nbatches):
        k = fold_in(key, b)

        def stage1():
            xi = sampler.sample(level, k, batch)
            s_f = sampler.eval(level, xi)
            s_c = sampler.eval(level + 1, xi, xi_level=level)
            return (s_f, s_c) + solver.solve_fwd(level + 1, s_c, **kw)

        (s_f, s_c, qc, _, info_c, p_c, lam_c), dt = timed(stage1)
        stages = [stage_row("stage1", dt, info_c.iterations, info_c.converged)]
        conv_c = info_c.converged
        for _ in range(segments - 1):
            if bool(conv_c.all()):
                break
            (qc, _, info_c, p_c, lam_c), dt = timed(solver.solve_fwd_x0, level + 1, s_c, p_c,
                                                     lam0=lam_c, **kw)
            conv_c = info_c.converged
            stages.append(stage_row("cont_c", dt, info_c.iterations, conv_c))
        (q, _, info_f, p, lam), dt = timed(solver.solve_fwd_warm, level, s_f, p_c, lam_c=lam_c,
                                           **kw)
        conv = info_f.converged
        stages.append(stage_row("stage2", dt, info_f.iterations, conv))
        for _ in range(segments - 1):
            if bool(conv.all()):
                break
            (q, _, info_f, p, lam), dt = timed(solver.solve_fwd_x0, level, s_f, p, lam0=lam, **kw)
            conv = info_f.converged
            stages.append(stage_row("cont_f", dt, info_f.iterations, conv))
        bt = sum(s["wall_s"] for s in stages)
        iters = float(sum(s["iterations"] for s in stages))
        e_y = float(np.mean(host(q).astype(np.float64) - host(qc).astype(np.float64)))
        report(f"batch {b}: " + " | ".join(
            f"{s['stage']} {s['wall_s']:6.2f}s it={s['iterations']:5.1f} "
            f"conv={s['converged']:.2f}" for s in stages))
        report(f"   total {bt:6.2f}s = {1e3 * bt / batch:6.2f} ms/sample, "
               f"iters {iters:.1f}, E[Y]~{e_y:.3f}")
        out["batches"].append(dict(stages=stages, total_s=bt, ms_per_sample=1e3 * bt / batch,
                                   iterations=iters, E_Y=e_y,
                                   converged=float(np.mean(host(conv)))))
        tot_t += bt
        tot_n += batch
        tot_iters += iters
    out.update(mean_ms_per_sample=1e3 * tot_t / tot_n, mean_iterations=tot_iters / nbatches)
    report(
        f"== mean {1e3 * tot_t / tot_n:.2f} ms/sample over {tot_n} samples, "
        f"mean iters/batch {tot_iters / nbatches:.1f}"
    )
    return out


if __name__ == "__main__":
    main()
