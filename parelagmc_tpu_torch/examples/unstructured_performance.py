"""Unstructured/agglomerated-path throughput with a scipy baseline. Twin of
examples/unstructured_performance.py.

The reference's defining capability is MLMC on general unstructured meshes
(the reference's examples/MLMC.cpp on meshes/cube_tet.mesh). This harness
measures that stack end to end:

  * Per level: the MLMC coupled pair step (UnstructuredSPDESampler
    eval_pair + UnstructuredDarcySolver solve_fwd_pair) in samples/s on
    the device, with mean Krylov iterations and a converged_fraction
    check; the coarsest level times the single-solve Q step.
  * A single-core scipy baseline on the SAME operators (assemble M(w) and
    sparse-LU the fine+coarse saddle pair per sample), giving a per-level
    ratio, plus a QoI ORACLE: the device Q must match the scipy Q on an
    identical w.
  * Solver-variant comparison (minres-bj / minres-coefmg / hybrid-cg).
  * A per-iteration cost at level 0 by iteration differencing (two
    fixed-budget runs at rtol 0).

Mesh: a tet mesh file (default cube_tet.mesh, the reference's
meshes/cube_tet.mesh, in the working directory) refined
--refine times (6 * 8^r tets for the cube), then agglomerated --levels deep
with --coarsening-factor (the reference's METIS workflow,
src/Utilities.cpp:125-155). Every measured call draws its own key (the
original's keys, so both packages draw the same samples) and its result is
copied to the host, which waits for the card; `compile_sec` is the wall of
the first (warm-up) call.

Devices: `--cpu` runs on the CPU (the original's meaning); otherwise
--device, default cuda:0, which raises without a card.

Usage: python -m parelagmc_tpu_torch.examples.unstructured_performance
        [--mesh cube_tet.mesh] [--refine 4] [--levels 4] [--batch 128]
        [--compare] [--cpu | --device cuda:0]
Writes UNSTRUCTURED_EVIDENCE_TORCH.json.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device, torch_dtype
from parelagmc_tpu_torch.examples._evidence import device_info, host, mean_of
from parelagmc_tpu_torch.fem.agglomeration import build_agglomerated_hierarchy
from parelagmc_tpu_torch.fem.simplicial_hierarchy import refine_simplicial
from parelagmc_tpu_torch.mesh.mfem_io import read_mfem_mesh
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.unstructured import (
    UnstructuredDarcySolver,
    UnstructuredSPDESampler,
    label_box_boundaries_gm,
)

DEFAULT_OUT = "UNSTRUCTURED_EVIDENCE_TORCH.json"


def timed(fn, key, batch, reps, label):
    t0 = time.perf_counter()
    warm = fn(fold_in(key, 987654))
    q0 = host(warm[0])
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(q0)):
        raise RuntimeError(f"{label}: warmup produced non-finite Q")
    dt, outs = np.inf, None
    for r in range(3):
        t0 = time.perf_counter()
        cur = [fn(fold_in(key, 100 * r + 10 + i)) for i in range(reps)]
        _ = [host(o[0]) for o in cur]
        d = time.perf_counter() - t0
        if d < dt:
            dt, outs = d, cur
    n = reps * batch
    iters = mean_of([o[2] for o in outs])
    conv = mean_of([o[1] for o in outs])
    print(
        f"  {label:30s} {dt / n * 1e3:10.4f} ms/sample "
        f"{n / dt:10.1f} samples/s  iters {iters:.1f} conv {conv * 100:.0f}% "
        f"(compile {compile_s:.1f}s)"
    )
    row = {
        "sec_per_sample": dt / n,
        "samples_per_sec": n / dt,
        "mean_iterations": iters,
        "converged_fraction": conv,
        "compile_sec": compile_s,
    }
    if conv < 1.0:
        print(f"  !! {label}: only {conv * 100:.0f}% converged - capture INVALID")
    return row


def _static_system(hier, solver, level):
    """(level, keep, ident, B, b) of the level's saddle system on the host,
    essential rows eliminated as the device solver eliminates them."""
    lvl = hier.levels[level]
    ess = host(solver._lv[level]["ess"])
    keep = sp.diags((~ess).astype(np.float64))
    ident = sp.diags(ess.astype(np.float64))
    B = (lvl.b_csr() @ keep).tocsr()
    b = host(solver._lv[level]["rhs"]).astype(np.float64)
    return lvl, keep, ident, B, b


def scipy_pair_baseline(hier, solver, level, nmeas=3):
    """Single-core reference-style cost: assemble M(w) and sparse-LU the
    fine and coarse saddle systems per sample, on the SAME operators and
    rhs the device solver uses."""
    rng = np.random.default_rng(0)
    lvls = [level] if level == hier.nlevels - 1 else [level, level + 1]
    static = [_static_system(hier, solver, l) for l in lvls]
    times = []
    for _ in range(max(nmeas, 3)):
        t0 = time.perf_counter()
        for lvl, keep, ident, B, b in static:
            w = np.exp(rng.normal(size=lvl.n_s))
            M = keep @ lvl.mass_csr(w) @ keep + ident
            A = sp.bmat([[M, B.T], [B, None]], format="csc")
            spla.splu(A).solve(b)
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def oracle_system(hier, solver, level, w):
    """(A, b, obs) of the oracle: the level's saddle matrix for the field w,
    its rhs and the QoI's weights, float64 on the host."""
    lvl, keep, ident, B, b = _static_system(hier, solver, level)
    M = keep @ lvl.mass_csr(np.asarray(w, np.float64)) @ keep + ident
    A = sp.bmat([[M, B.T], [B, None]], format="csc")
    return A, b, host(solver._lv[level]["obs"]).astype(np.float64)


def oracle_solve(A, b, obs):
    """The QoI of a direct sparse solve of A x = b."""
    return float(spla.splu(A).solve(b) @ obs)


def scipy_qoi_oracle(hier, solver, level, w):
    """Direct sparse solve of the same saddle system: the device Q must
    match."""
    return oracle_solve(*oracle_system(hier, solver, level, w))


def build_parser():
    """The driver's options (the original's, plus --device)."""
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="cube_tet.mesh",
                   help="MFEM tet mesh file (the reference's meshes/cube_tet.mesh; "
                        "default: that name in the working directory)")
    p.add_argument("--refine", type=int, default=4,
                   help="uniform refinements of the file mesh before "
                        "agglomeration (6 * 8^r tets)")
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--coarsening-factor", type=int, default=8)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--solver", default="hybrid-cg")
    p.add_argument("--compare", action="store_true",
                   help="also time minres-bj and minres-coefmg")
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--max-iterations", type=int, default=800,
                   help="batch-max Krylov budget")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--corlen", type=float, default=0.3)
    p.add_argument("--variance", type=float, default=0.25)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--cpu", action="store_true", help="run on the host CPU")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; --cpu for the CPU)")
    return p


def read_hierarchy(args):
    """(hierarchy, seconds of its agglomeration): the mesh file refined
    --refine times, agglomerated --levels deep."""
    gm = read_mfem_mesh(args.mesh)
    label_box_boundaries_gm(gm)
    for _ in range(args.refine):
        gm, _ = refine_simplicial(gm)
    t0 = time.perf_counter()
    hier = build_agglomerated_hierarchy(
        gm, args.levels, coarsening_factor=args.coarsening_factor
    )
    return hier, time.perf_counter() - t0


def problem_config(args, name):
    """The solvers' configuration, darcy_solver.name `name`."""
    cfg = ProblemConfig(
        refinements=args.levels - 1,
        correlation_length=args.corlen,
        variance=args.variance,
        batch_size=args.batch,
        dtype=args.dtype,
    )
    cfg.darcy_solver.name = name
    cfg.darcy_solver.relative_tolerance = args.rtol
    cfg.darcy_solver.max_iterations = args.max_iterations
    return cfg


def oracle_field(hier, variance):
    """The oracle's log-normal field on level 0 (numpy seed 7)."""
    rng = np.random.default_rng(7)
    return np.exp(variance ** 0.5 * rng.normal(size=hier.levels[0].n_s))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    dtype = torch_dtype(args.dtype)

    hier, setup_hier_s = read_hierarchy(args)
    print(f"-- hierarchy: {[l.n_s for l in hier.levels]} cells, "
          f"{[l.n_u for l in hier.levels]} faces (built {setup_hier_s:.1f}s)")

    def make(name):
        cfg = problem_config(args, name)
        t0 = time.perf_counter()
        solver = UnstructuredDarcySolver(hier, cfg, dtype, device)
        return cfg, solver, time.perf_counter() - t0

    cfg, solver, setup_s = make(args.solver)
    sampler = UnstructuredSPDESampler(hier, cfg, dtype, device)
    key = PRNGKey(0)
    batch = args.batch
    reps = max(2, args.samples // batch)

    evidence = {
        "mesh": f"{args.mesh} x{args.refine} refinements",
        "cells": [int(l.n_s) for l in hier.levels],
        "faces": [int(l.n_u) for l in hier.levels],
        "coarsening_factor": args.coarsening_factor,
        "batch": batch,
        "rtol": args.rtol,
        "dtype": args.dtype,
        "solver": args.solver,
        "device": device_info(device),
        "setup_sec": {"hierarchy": setup_hier_s, "solver": setup_s},
        "levels": [],
        "variants": {},
    }

    # QoI oracle on level 0 (device against scipy, identical w).
    w_or = oracle_field(hier, args.variance)
    q_dev = float(host(solver.solve_fwd(
        0, torch.as_tensor(w_or[None], dtype=dtype, device=device))[0])[0])
    q_sp = scipy_qoi_oracle(hier, solver, 0, w_or)
    evidence["qoi_oracle"] = {
        "q_device": q_dev, "q_scipy": q_sp,
        "rel_err": abs(q_dev - q_sp) / abs(q_sp),
    }
    print(f"-- QoI oracle level 0: device {q_dev:.6g} vs scipy {q_sp:.6g} "
          f"(rel {evidence['qoi_oracle']['rel_err']:.1e})")

    def pair_step(sol, level):
        def step(k):
            xi = sampler.sample(level, k, batch)
            s_f, s_c = sampler.eval_pair(level, xi)
            q, qc, i_f, i_c = sol.solve_fwd_pair(level, s_f, s_c)
            return q - qc, i_f.converged & i_c.converged, i_f.iterations + i_c.iterations

        return step

    print(f"-- MLMC pair throughput ({args.solver}, batch {batch})")
    for level in range(hier.nlevels):
        if level < hier.nlevels - 1:
            step = pair_step(solver, level)
            label = f"L{level} pair"
        else:

            def step(k, level=level):
                xi = sampler.sample(level, k, batch)
                s = sampler.eval(level, xi)
                q, _, info = solver.solve_fwd(level, s)
                return q, info.converged, info.iterations

            label = f"L{level} single"
        row = {"level": level,
               "darcy_dofs": int(solver.num_dofs(level)),
               "batch": batch}
        row["pair"] = timed(step, key, batch, reps, label)
        base = scipy_pair_baseline(hier, solver, level)
        row["scipy_sec_per_sample_1core"] = base
        row["vs_scipy_1core"] = base / row["pair"]["sec_per_sample"]
        row["vs_64rank_proxy"] = row["vs_scipy_1core"] / 64.0
        print(f"    scipy 1-core {base * 1e3:.2f} ms/sample -> "
              f"{row['vs_scipy_1core']:.1f}x (1-core), "
              f"{row['vs_64rank_proxy']:.2f}x (64-rank proxy)")
        evidence["levels"].append(row)

    if args.compare:
        print("-- solver variants, level-0 pair")
        for name in ("minres-bj", "minres-coefmg", "hybrid-cg"):
            if name == "minres-bj":
                cfg_v = ProblemConfig(
                    refinements=args.levels - 1, batch_size=batch,
                    correlation_length=args.corlen, variance=args.variance,
                    dtype=args.dtype,
                )
                cfg_v.darcy_solver.relative_tolerance = args.rtol
                cfg_v.darcy_solver.max_iterations = args.max_iterations
                sol_v = UnstructuredDarcySolver(hier, cfg_v, dtype, device)
            else:
                _, sol_v, _ = make(name)
            evidence["variants"][name] = timed(pair_step(sol_v, 0), key, batch, reps, name)

    # Per-iteration cost at level 0 by iteration differencing (fixed
    # budgets m and 2m at rtol 0: the difference isolates the Krylov body
    # from setup and QoI).
    m_it = 24
    prof = {}
    w_prof = torch.as_tensor(
        np.exp(args.variance ** 0.5
               * np.random.default_rng(3).normal(size=(batch, hier.levels[0].n_s))),
        dtype=dtype, device=device,
    )
    old = solver.solver_cfg
    for tag, budget in (("m", m_it), ("2m", 2 * m_it)):
        solver.solver_cfg = dataclasses.replace(
            old, max_iterations=budget, relative_tolerance=0.0,
            absolute_tolerance=0.0,
        )
        host(solver.solve_fwd(0, w_prof)[0])
        t0 = time.perf_counter()
        for i in range(4):
            host(solver.solve_fwd(0, w_prof * (1.0 + 1e-6 * i))[0])
        prof[tag] = (time.perf_counter() - t0) / 4
    solver.solver_cfg = old
    per_iter = (prof["2m"] - prof["m"]) / m_it
    evidence["profile_level0"] = {
        "fixed_budget_sec": prof,
        "sec_per_krylov_iteration_batch": per_iter,
        "ms_per_iteration_per_sample": per_iter / batch * 1e3,
    }
    print(f"-- level-0 per-iteration cost: {per_iter * 1e3:.2f} ms/batch-iter "
          f"({per_iter / batch * 1e6:.1f} us/sample-iter)")

    with open(args.out, "w") as f:
        json.dump(evidence, f, indent=1)
    print(f"written: {args.out}")
    return evidence


if __name__ == "__main__":
    main()
