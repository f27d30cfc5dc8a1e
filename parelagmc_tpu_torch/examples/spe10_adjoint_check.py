"""Full-scale SPE10 validity and cost check for the adjoint-corrected QoI
(config.adjoint_qoi). Twin of examples/spe10_adjoint_check.py.

Per-sample MLMC correction Y = Q_0 - Q_1 against a deep-converged truth,
for

  plain   : primal-only solves at --plain-rtol   (production 1e-5)
  adjoint : primal+adjoint solves at --adjoint-rtol (default 1e-4)

At SPE10's ~1e6 contrast the flux QoI error is far larger than the relative
residual, so a plain loose rtol is QoI-invalid; the adjoint correction makes
the QoI error the PRODUCT of the primal and adjoint energy errors, which is
what lets loose rtols produce tight QoIs. This harness checks that at full
scale and prices it per converged pair.

Reference analog: none - the reference brute-forces solver tolerance in
f64 (examples/SPE10/SPE10_MLMC.cpp uses fixed tight tolerances).

Devices: `--platform cpu` runs on the CPU in float64 (the original's
meaning); without it the check runs on --device (default cuda:0) in
float32, and raises without a card.

Usage: python -m parelagmc_tpu_torch.examples.spe10_adjoint_check
        [--batch 8] [--seed 7] [--adjoint-rtol 1e-4] [--plain-rtol 1e-5]
        [--truth-rtol 1e-7] [--max-iters 40] [--grid 60,220,85]
        [--platform cpu] [--device cuda:0] [--solver-opt KEY=VALUE ...]
        [--out SPE10_ADJOINT_EVIDENCE_TORCH.json]
"""

import json
import sys
import time

import numpy as np

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples._evidence import host
from parelagmc_tpu_torch.examples.common import apply_solver_opt
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem

DEFAULT_OUT = "SPE10_ADJOINT_EVIDENCE_TORCH.json"
FULL_GRID = (60, 220, 85)
MAX_SEGMENTS = 40


def build(grid, batch, seed, adjoint, rtol, dtype, device, max_iters=40, solver_opts=()):
    """The check's problem: the full SPE10 grid (3 levels), or a scaled
    synthetic-SPE10 box of 2 levels with fine = `grid`; cg-schur-coefmg
    with local Schur scaling at `rtol`, `max_iters` iterations a solve
    call, the adjoint correction if `adjoint`, then `solver_opts`."""
    if grid == FULL_GRID:
        mesh_kw = dict(mesh="spe10", refinements=2)
    else:
        # Scaled synthetic-SPE10 box: 2 levels, fine = 2 x ncells.
        assert all(g % 2 == 0 for g in grid), "--grid dims must be even"
        mesh_kw = dict(
            mesh="box",
            ncells=(grid[0] // 2, grid[1] // 2, grid[2] // 2),
            lengths=(1200.0, 2200.0, 170.0),
            refinements=1,
        )
    cfg = ProblemConfig(
        batch_size=batch,
        correlation_length=100.0,
        normalize_marginals=True,
        dtype=dtype,
        axis_order="auto",
        seed=seed,
        **mesh_kw,
    )
    cfg.darcy_solver.name = "cg-schur-coefmg"
    # Iterations per solve call, with host continuations after it; an
    # adjoint_qoi call holds TWO Krylov solves, hence half of the plain
    # harness's 80.
    cfg.darcy_solver.max_iterations = max_iters
    cfg.darcy_solver.relative_tolerance = rtol
    cfg.darcy_solver.local_schur_scaling = True
    cfg.darcy_solver.adjoint_qoi = adjoint
    for kv in solver_opts:
        apply_solver_opt(cfg.darcy_solver, kv)
    return build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=device)


def sample_fields(prob, seed, batch):
    """(fine, coarse) fields of the check's samples: level 0's draw from
    PRNGKey(seed), and its coarse counterpart on level 1."""
    xi = prob.sampler.sample(0, PRNGKey(seed), batch)
    return prob.sampler.eval(0, xi), prob.sampler.eval(1, xi, xi_level=0)


def pair_once(solver, w_f, w_c, adjoint):
    """One coarse-then-fine warm pair with host-side segmented continuation
    of either solve until every sample has converged: (fine Q, coarse Q,
    iterations, fine segments, seconds, converged), the QoIs float64 on the
    host."""
    kw = dict(return_pressure=True, return_adjoint=adjoint)

    def unpack(out):
        if adjoint:
            q, _, info, p, lam = out
            return q, p, lam, info.iterations, info.converged
        q, _, info, p = out
        return q, p, None, info.iterations, info.converged

    t0 = time.perf_counter()
    qc, p_c, lam_c, it, conv_c = unpack(solver.solve_fwd(1, w_c, **kw))
    for _ in range(MAX_SEGMENTS):
        if bool(conv_c.all()):
            break
        qc, p_c, lam_c, it2, conv_c = unpack(solver.solve_fwd_x0(1, w_c, p_c, lam0=lam_c, **kw))
        it = it + it2
    iters = int(np.max(host(it)))
    q, p, lam, it, conv = unpack(solver.solve_fwd_warm(0, w_f, p_c, lam_c=lam_c, **kw))
    segs = 1
    for _ in range(MAX_SEGMENTS):
        if bool(conv.all()):
            break
        q, p, lam, it2, conv = unpack(solver.solve_fwd_x0(0, w_f, p, lam0=lam, **kw))
        it = it + it2
        segs += 1
    iters += int(np.max(host(it)))
    q = host(q)
    dt = time.perf_counter() - t0
    return (
        q.astype(np.float64),
        host(qc).astype(np.float64),
        iters,
        segs,
        dt,
        bool(host(conv).all() and host(conv_c).all()),
    )


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    get = lambda k, d, c=str: c(argv[argv.index(k) + 1]) if k in argv else d

    cpu = get("--platform", "") == "cpu"
    device = resolve_device("cpu" if cpu else get("--device", None))
    batch = get("--batch", 8, int)
    seed = get("--seed", 7, int)
    grid = tuple(int(t) for t in get("--grid", "60,220,85").split(","))
    rtols = {
        "plain": get("--plain-rtol", 1e-5, float),
        "adjoint": get("--adjoint-rtol", 1e-4, float),
        "truth": get("--truth-rtol", 1e-7, float),
    }
    out_file = get("--out", DEFAULT_OUT)
    # Extra DarcySolverConfig fields applied to the ADJOINT variant only
    # (truth and plain legs stay at the anchored configuration), e.g.
    #   --solver-opt adjoint_stacked=true --solver-opt meanfield_x0=true
    # so a candidate solver lever is priced against the unchanged truth.
    solver_opts = [
        argv[i + 1] for i, tok in enumerate(argv) if tok == "--solver-opt"
    ]
    dtype = "float64" if cpu else "float32"
    max_iters = get("--max-iters", 40, int)

    # One problem instance provides the sample fields; every variant solves
    # the SAME realizations (pairwise comparable Y per sample). The truth
    # run is also adjoint-corrected: its QoI error is the product of its
    # primal and adjoint energy errors (~rtol^2), far below a plain solve at
    # the same rtol.
    p0 = build(grid, batch, seed, True, rtols["truth"], dtype, device, max_iters)
    s_f, s_c = sample_fields(p0, seed, batch)

    def run_pair(prob, adjoint, label):
        """A warm-up pair on perturbed fields, then the best of two measured
        pairs (the fields of round r scaled by 1 + 1e-7 r, the original's)."""
        pair_once(prob.solver, s_f * (1 + 1e-6), s_c * (1 + 1e-6), adjoint)
        best = None
        for r in range(2):
            cur = pair_once(prob.solver, s_f * (1 + 1e-7 * r), s_c * (1 + 1e-7 * r), adjoint)
            if best is None or cur[4] < best[4]:
                best = cur
        q, qc, iters, segs, dt, conv = best
        print(
            f"  {label:22s} iters {iters:4d} segs {segs} "
            f"{dt / batch * 1e3:9.1f} ms/sample conv {conv}"
        )
        return {
            "q": q, "qc": qc, "iterations": iters, "segments": segs,
            "sec_per_sample": dt / batch, "converged": conv,
        }

    print(f"SPE10 adjoint-QoI check: grid {grid}, batch {batch}, "
          f"{'CPU f64' if cpu else f'{device} f32'}")
    results = {}
    results["truth"] = run_pair(p0, True, f"truth adjoint@{rtols['truth']:g}")
    results["plain"] = run_pair(
        build(grid, batch, seed, False, rtols["plain"], dtype, device, max_iters), False,
        f"plain@{rtols['plain']:g}")
    results["adjoint"] = run_pair(
        build(grid, batch, seed, True, rtols["adjoint"], dtype, device, max_iters, solver_opts),
        True, f"adjoint@{rtols['adjoint']:g}")

    yt = results["truth"]["q"] - results["truth"]["qc"]
    report = {"config": {"grid": list(grid), "batch": batch, "seed": seed,
                         "rtols": rtols, "platform": "cpu" if cpu else device.type,
                         "adjoint_solver_opts": solver_opts},
              "device": device_info(device)}
    for name in ("plain", "adjoint"):
        r = results[name]
        y = r["q"] - r["qc"]
        rel_y = np.max(np.abs(y - yt) / np.maximum(np.abs(yt), 1e-30))
        rel_q = np.max(np.abs(r["q"] - results["truth"]["q"])
                       / np.maximum(np.abs(results["truth"]["q"]), 1e-30))
        report[name] = {
            "max_rel_Y_error": float(rel_y),
            "max_rel_Q_error": float(rel_q),
            "iterations": r["iterations"],
            "segments": r["segments"],
            "sec_per_sample": r["sec_per_sample"],
            "converged": r["converged"],
        }
        print(f"  {name:8s} max rel Y err {rel_y:.3e}  max rel Q err "
              f"{rel_q:.3e}  {r['sec_per_sample'] * 1e3:.1f} ms/sample")
    report["truth"] = {
        "iterations": results["truth"]["iterations"],
        "sec_per_sample": results["truth"]["sec_per_sample"],
        "converged": results["truth"]["converged"],
        "E_Y": float(np.mean(yt)),
    }
    with open(out_file, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_file}")


if __name__ == "__main__":
    main()
