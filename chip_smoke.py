#!/usr/bin/env python3
"""Smoke run of the PyTorch port (parelagmc_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line (or block) before the last line:

1. build   - compile the CUDA kernels from csrc/ with nvcc (seconds).
2. K1      - the Thomas kernel against its plain PyTorch version on the
             M(w)^{-1} line tables that build_problem's finest level factors
             for a sampled field: golden (16^3, batch 512) and 64^3 (batch
             64), float32 and float64: max relative error and ms per M^{-1}
             apply (three axis solves).
3. K2      - the threefry normal kernel against its plain version: raw bits
             identical (32 and 64 bit), normals within tolerance, moments,
             ms per draw of the golden noise batch.
4. MLMC    - the golden MLMC run through build_problem + MLMCManager.run()
             (float32, Darcy rtol 1e-5): dofs 17152/2240/304, |estimate -
             2.56| < 0.25, per-level consistency < 1, both kernels launched
             (launch counts reset just before the run, read just after).
5. bench   - the golden pair step with bench.py's settings (batch 512,
             rtol 1e-4, 50 iterations, local Schur scaling): samples/s and
             E[Q] within 2.55 +- 0.12. (profile_pair_step.py splits this
             step into layers and device/host time.)
6. 64^3    - the pair step at refinements=4 (64^3 against 32^3), batch 64,
             rtol 1e-5 (float64, see BIG_DTYPE below): samples/s,
             iterations, converged fraction (must be 1.0), peak memory.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failure
exits non-zero before the last line; without a CUDA card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
F32_TOL_K1, F64_TOL_K1 = 1e-5, 1e-12  # rel. to max |x|; same recurrence, FMA vs not
F32_TOL_K2, F64_TOL_K2 = 1e-5, 1e-12  # |a-b|/(1+|b|); CUDA erfinv vs PyTorch's
# (refinements, batch, label) of the M(w)^{-1} tables K1 is checked on.
K1_CASES = ((2, 512, "golden 16^3"), (4, 64, "64^3"))
K2_SHAPE = (512, 4096)  # one golden pair batch of level-0 noise
BENCH_BATCH, BIG_REFINEMENTS, BIG_BATCH = 512, 4, 64
# The 64^3 pair runs in float64 without CG restarts and with up to 2000
# iterations: on this config the sqrt(w)-scaled exact-S(1) preconditioner
# needs 560-1000+ iterations per solve in float64 at batch 64 (measured on
# the H100), float32 at rtol 1e-5 with restarts every 50 does not converge
# within 500, and restarts - a float32 rescue - only slow float64 CG down
# (PERF.md, Findings).
BIG_DTYPE, BIG_MAXIT, BIG_RESTART = "float64", 2000, 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device milliseconds per call of fn, by CUDA events."""
    import torch

    for _ in range(warmup):
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


def mass_tables(refinements: int, batch: int, dtype, device):
    """The per-axis (dl, d, du) line tables that the main path's M(w)^{-1}
    builds on the finest level of build_problem at `refinements`, for one
    batch of the sampler's own coefficient field, plus a random right-hand
    side of each table's shape."""
    import torch

    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem

    cfg = ProblemConfig(refinements=refinements, batch_size=batch,
                        dtype=str(dtype).replace("torch.", ""))
    prob = build_problem(cfg, device=device)
    level = prob.solver.levels[0]
    w = prob.sampler.eval(0, prob.sampler.sample(0, PRNGKey(refinements), batch))
    fac = level.mass_solver.factor(w)
    g = torch.Generator(device=device).manual_seed(refinements)
    rhs = [torch.randn(t[1].shape, generator=g, device=device, dtype=dtype) for t in fac]
    return fac, rhs, level


def phase_k1(device, gpu: str):
    import torch

    from parelagmc_tpu_torch.ops.tridiag_pallas import thomas, thomas_plain

    main_path = None
    for refinements, batch, label in K1_CASES:
        for dtype, tol in ((torch.float32, F32_TOL_K1), (torch.float64, F64_TOL_K1)):
            fac, rhs, lvl = mass_tables(refinements, batch, dtype, device)
            rel, abs_err = 0.0, 0.0
            for (dl, d, du), b in zip(fac, rhs):
                xk = thomas(dl, d, du, b)
                xp = thomas_plain(dl, d, du, b)
                torch.cuda.synchronize()
                diff = (xk - xp).abs().max().item()
                rel = max(rel, diff / xp.abs().max().item())
                abs_err = max(abs_err, diff)
                if not torch.isfinite(xk).all():
                    fail(f"K1 non-finite output at {label}")
            ms = cuda_ms(lambda: [thomas(*t, b) for t, b in zip(fac, rhs)])
            plain_ms = cuda_ms(lambda: [thomas_plain(*t, b) for t, b in zip(fac, rhs)], reps=5)
            name = str(dtype).replace("torch.", "")
            print(f"K1 thomas {label} batch {batch} {name}: faces/sample {lvl.n_u} "
                  f"max_rel_err {rel:.3e} (tol {tol:g}) kernel {ms:.4f} ms/apply "
                  f"plain {plain_ms:.4f} ms/apply [{gpu}]", flush=True)
            if not rel <= tol:
                fail(f"K1 {label} {name}: rel err {rel} > {tol}")
            if main_path is None and dtype == torch.float32:
                main_path = (abs_err, ms, plain_ms)
    return main_path


def phase_k2(device, gpu: str):
    import torch

    from parelagmc_tpu_torch.ops import prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(0), 0), 1)
    shape = K2_SHAPE
    for bw in (32, 64):
        kb = prng.random_bits(key, bw, shape, device)
        pb = prng.random_bits_plain(key, bw, shape, device)
        if not torch.equal(kb, pb):
            fail(f"K2 {bw}-bit raw bits differ from the plain version")
    main_path = None
    for dtype, tol in ((torch.float32, F32_TOL_K2), (torch.float64, F64_TOL_K2)):
        xk = prng.sample_normals(key, shape, dtype, device)
        xp = prng.normals_plain(key, shape, dtype, device)
        torch.cuda.synchronize()
        scaled = ((xk - xp).abs() / (1.0 + xp.abs())).max().item()
        abs_err = (xk - xp).abs().max().item()
        x64 = xk.double()
        mean, std = x64.mean().item(), x64.std().item()
        kurt = ((x64 - mean) ** 4).mean().item() / std ** 4
        ms = cuda_ms(lambda: prng.sample_normals(key, shape, dtype, device))
        plain_ms = cuda_ms(lambda: prng.normals_plain(key, shape, dtype, device), reps=5)
        name = str(dtype).replace("torch.", "")
        print(f"K2 threefry normals {shape} {name}: bits32/64 identical, "
              f"max_abs_err {abs_err:.3e} scaled_err {scaled:.3e} (tol {tol:g}) "
              f"mean {mean:+.5f} std {std:.5f} kurtosis {kurt:.4f} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{gpu}]", flush=True)
        if not scaled <= tol:
            fail(f"K2 normals {name}: err {scaled} > {tol}")
        if not (abs(mean) < 0.01 and abs(std - 1.0) < 0.01 and abs(kurt - 3.0) < 0.05):
            fail(f"K2 normals {name}: moments off ({mean}, {std}, {kurt})")
        if dtype == torch.float32:
            main_path = (abs_err, ms, plain_ms)
    return main_path


def phase_mlmc(device, gpu: str):
    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg = ProblemConfig(refinements=2)  # the golden config: 4^3 box, side 2, x2 refined
    cfg.darcy_solver.relative_tolerance = 1e-5
    cfg.output_filename = ""
    prob = build_problem(cfg, device=device)
    dofs = [prob.solver.num_dofs(l) for l in range(3)]
    if dofs != [17152, 2240, 304]:
        fail(f"golden dofs {dofs}")
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est = mgr.run()
    dt = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    print(mgr.show_me(), flush=True)
    cons = [float(c) for c in mgr.consistency[:-1]]
    print(f"MLMC golden: estimate {est:.6f} dofs {dofs} consistency {cons} "
          f"samples {mgr.level_nsamples.tolist()} run {dt:.2f} s "
          f"launches {launches} [{gpu}]", flush=True)
    if not math.isfinite(est) or abs(est - 2.56) >= 0.25:
        fail(f"golden estimate {est} not within 0.25 of 2.56")
    if not all(c < 1.0 for c in cons):
        fail(f"consistency {cons}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched by the golden MLMC run")
    return launches


def pair_problem(refinements: int, batch: int, rtol: float, maxit: int, dtype: str, device,
                 restart_every: int = 50):
    """build_problem for a pair step with the local Schur scaling."""
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem

    cfg = ProblemConfig(refinements=refinements, batch_size=batch, dtype=dtype)
    cfg.darcy_solver.relative_tolerance = rtol
    cfg.darcy_solver.max_iterations = maxit
    cfg.darcy_solver.local_schur_scaling = True
    cfg.darcy_solver.restart_every = restart_every
    cfg.output_filename = ""
    return build_problem(cfg, device=device)


def phase_bench(device, gpu: str):
    """bench.py's golden pair step on the port."""
    import torch

    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    batch = BENCH_BATCH
    prob = pair_problem(2, batch, 1e-4, 50, "float32", device)
    sampler, solver = prob.sampler, prob.solver

    def pair_step(key):
        xi = sampler.sample(0, key, batch)
        s_f = sampler.eval(0, xi)
        s_c = sampler.eval(1, xi, xi_level=0)
        q, qc, info_f, info_c = solver.solve_fwd_pair(0, s_f, s_c)
        return q, q - qc, info_f, info_c

    key = PRNGKey(0)
    pair_step(key)[0].cpu()  # warm-up
    reps, rounds = 8, 3
    best_dt, eq, qs_all = math.inf, 0.0, None
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [pair_step(fold_in(key, 100 * r + i)) for i in range(reps)]
        qs = torch.stack([o[0] for o in outs]).double().cpu()
        dt = time.perf_counter() - t0
        if dt < best_dt:
            best_dt, eq, qs_all = dt, float(qs.mean()), qs
    sps = reps * batch / best_dt
    if not torch.isfinite(qs_all).all():
        fail("bench pair step produced non-finite Q")
    print(f"bench pair step (golden, batch {batch}, rtol 1e-4, 50 it, local scaling, f32): "
          f"{sps:.1f} samples/s best of {rounds}x{reps} steps, E[Q] {eq:.4f} "
          f"[{gpu}]", flush=True)
    if abs(eq - 2.55) > 0.12:
        fail(f"bench E[Q] {eq} outside 2.55 +- 0.12")


def phase_64(device, gpu: str):
    import torch

    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    batch = BIG_BATCH
    prob = pair_problem(BIG_REFINEMENTS, batch, 1e-5, BIG_MAXIT, BIG_DTYPE, device,
                        restart_every=BIG_RESTART)
    sampler, solver = prob.sampler, prob.solver
    n_s = solver.levels[0].n_s
    n_u = solver.levels[0].n_u
    key = fold_in(PRNGKey(0), 64)
    torch.cuda.reset_peak_memory_stats(device)
    rates, iters, conv = [], [], []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xi = sampler.sample(0, fold_in(key, rep), batch)
        s_f = sampler.eval(0, xi)
        s_c = sampler.eval(1, xi, xi_level=0)
        q, qc, info_f, info_c = solver.solve_fwd_pair(0, s_f, s_c)
        q = q.double().cpu()
        dt = time.perf_counter() - t0
        rates.append(batch / dt)
        iters.append((info_c.iterations, info_f.iterations))
        conv.append(float(torch.cat([info_f.converged, info_c.converged]).float().mean()))
        if not torch.isfinite(q).all():
            fail("64^3 pair produced non-finite Q")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"64^3 pair step ({BIG_DTYPE}, batch {batch}, {n_s} cells + {n_u} faces per "
          f"sample, rtol 1e-5, <={BIG_MAXIT} it, restart {BIG_RESTART}, local scaling): "
          f"samples/s per step {[round(r, 2) for r in rates]} (first includes warm-up) "
          f"iterations (coarse, fine) {iters} converged fraction {conv} "
          f"E[Q] {float(q.mean()):.4f} peak mem {peak_gb:.2f} GB [{gpu}]", flush=True)
    if min(conv) < 1.0:
        fail(f"64^3 pair converged fraction {conv}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import parelagmc_tpu_torch
        from parelagmc_tpu_torch import kernels
    except ImportError as e:
        fail(f"parelagmc_tpu_torch not importable beside {__file__}: {e}")
    if not os.path.abspath(parelagmc_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"imported {parelagmc_tpu_torch.__file__}, not the checkout at {HERE}")
    if "jax" in sys.modules:
        fail("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    gpu = gpu_info()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    so = kernels.build_library()
    kernels.library()
    print(f"build: {os.path.relpath(so, HERE)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'})"
          f" [{gpu}]", flush=True)

    k1 = phase_k1(device, gpu)
    k2 = phase_k2(device, gpu)
    launches = phase_mlmc(device, gpu)
    phase_bench(device, gpu)
    phase_64(device, gpu)
    if "jax" in sys.modules:
        fail("jax was imported")

    report = {"kernels": [
        {"name": "thomas", "route": "cuda",
         "source": "parelagmc_tpu_torch/csrc/thomas.cu",
         "replaces": "parelagmc_tpu/ops/tridiag_pallas.py:77",
         "launches": launches["thomas"], "max_abs_err": k1[0],
         "ms": k1[1], "plain_ms": k1[2]},
        {"name": "threefry_normal", "route": "cuda",
         "source": "parelagmc_tpu_torch/csrc/threefry_normal.cu",
         "replaces": "parelagmc_tpu/ops/prng.py:40",
         "launches": launches["threefry_normal"], "max_abs_err": k2[0],
         "ms": k2[1], "plain_ms": k2[2]},
    ]}
    print(json.dumps(report), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
