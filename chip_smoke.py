#!/usr/bin/env python3
"""Smoke run of the PyTorch port (parelagmc_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line (or block) before the last line:

1. build   - compile the CUDA kernels from csrc/ with nvcc, one process per
             source, all started together (seconds).
2. K1      - M(w)^{-1} through the K1 kernel (apply_factored on CUDA
             tensors: one launch per mesh axis on the flat face layout)
             against its plain composed version (apply_plain) on the tables
             that build_problem's finest level factors for a sampled field:
             golden (16^3, batch 512) and 64^3 (batch 64), float32 and
             float64: max error relative to max |z|, kernel, plain and bound
             ms per apply, and the kernel's ms per axis beside each axis's
             bound.
3. K2      - the threefry normal kernel against its plain version: raw bits
             identical (32 and 64 bit), normals within tolerance, moments,
             ms per draw of the golden noise batch, beside torch.randn.
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
7. K3      - the threefry uniform kernel (K2's uniform mode) through its
             entry point sample_uniforms, then against its plain version at
             (512, 4096) in float32 and float64: identical values, moments,
             ms per draw, beside torch.rand.
8. anchor  - the scaled SPE10 MLMC anchor of tests/test_spe10_anchor.py on
             the card (16x32x8 grid, synthetic permeability, f64,
             cg-schur-coefmg, rtol 1e-8, init_run([32, 32, 32])): dofs
             17280/2272/312, |estimate - 361.882| < 0.5, E[Q] within 2e-3
             of the pins, consistency < 0.1, both kernels launched; then
             M(w)^{-1} (K1) and K2 against their plain versions at the
             shapes this path gives them (every level's M(w)^{-1} tables
             and noise draw at batch 16, float64).
9. SPE10   - the full 60x220x85 grid with the production solver settings
             (physics/spe10.full_grid_solver_defaults, float32, corlen 100,
             normalized marginals, axis_order auto, synthetic permeability):
             host setup seconds, then
   9a. K1 on the coefMG line tables: struct_mg_setup on a sampled level-1
       field with coefmg_line_axes "auto", kernel (the special case of
       (n, L) tables, solved axis first) against its plain version per
       line axis in float32 and bfloat16 (max relative error, kernel,
       plain and bound ms per line solve). An isolated check: the
       production settings leave line smoothing off, so 9b reaches
       neither the line smoother nor the bf16 kernel;
   9b. MLMCManager.init_run([8, 128, 512]) (both kernels launched), then
       one timed batch per level: converged fraction 1.0, finite Q,
       iterations below the manager's pair budget; C_l, iterations and E[Q]
       per level, peak memory, CUDA-event ms of one level-0 V-cycle; then
       M(w)^{-1} (K1) and K2 against their plain versions at the shapes
       this path gives them: every level's M(w)^{-1} tables (kinv_ref
       Galerkin blocks, batches 8/128/512, float32) and noise draws ((8,
       1122000), (128, 138600), (512, 17325)).

10. samplers - on the golden box (16^3/8^3/4^3, float32, batch 512) the
             matching and the projection embedding (n_buffer 1) and the
             analytic and Matern KL samplers, each through build_problem:
             a draw and an evaluation on every level, the coupled coarse
             one included (finite, of the field's shape); K2 against its
             plain version at each new draw shape; matching and projection
             agree on their common embedded mesh; one MLMCManager.init_run
             per sampler (finite E[Q], both kernels launched) and one cold
             solve per level with converged fraction 1.0. Then the
             projection sampler at 64^3 cells (buffer 8 fine cells a side,
             float64, batch 64): ms per eval, ELL width, peak memory. Then
             the Egg model (60x60x7, projection embedding, float64, the run
             of tests/test_nondyadic.py:115-131): embedded shapes (64, 64,
             11) and (32, 32, 5) and the estimate (see EGG below).
11. ratio anchor - examples/spe10_ratio_mlmc.py --grid 16,32,8
             --refinements 1 --samples 8 --batch 8 --dtype float64 through
             build_problem, BayesianInverseProblem and BayesRatioManager
             on cg-schur-coefmg: ratio estimate within 2e-3 of 354.436,
             splitting estimate (the same moment table) within 2e-3 of
             350.767, 8 samples per level, E[Z] > 0.01. (The pins were taken
             on "cg-schur": phase 13a.)
12. ratio  - the Bayesian ratio estimators on the full SPE10 grid, this
             slice's full width: phase 9's problem (its config carries the
             three wells of examples/spe10_ratio_mlmc.py, radius 30 ft),
             observation data from one prior draw, the example's solver
             canary (8 samples and one cold solve per level: converged
             fraction 1.0 required), BayesRatioManager.init_run([8, 128,
             512]) (one batch per level after a discarded warm-up batch),
             both estimates from the one moment table, show_me(), C_l,
             launches of K1 and K2, peak memory; finite estimates and
             E[Z] > 0 on every level required.

13. solvers - the remaining Darcy solvers.
   13a. On the scaled SPE10 grid (16x32x8, float64, rtol 1e-8, phase 8's
       run): the MLMC estimate under "cg-schur" with a kinv_ref (the static
       Schur multigrid: geometric-mean and local scaling, and with the line
       smoother on K1's static tables), cg-schur-diag, cg-schur-exact,
       cg-schur-coefmg with the gather tables, each within 0.5 of 361.882
       with one cold solve of 16 samples per level converged 1.0; and
       minres-bj on levels 1 and 2 alone (its level-0 solves, ~52 000 MINRES
       iterations each, were 3 to 6 minutes of the script), their E[Y] held
       to the first case's on the same keys (MINRES_SCALED_SAMPLES); its
       cold solves are those of the next check: minres-bj
       against cg-schur on levels MINRES_SCALED_LEVELS of that grid (Q per
       sample to 1e-4, both converged 1.0); then phase 11's ratio and
       splitting anchors on "cg-schur" within 1e-3 of 354.436 / 350.767.
   13b. Full width, one batch per level of the full SPE10 grid at the
       production settings: the sequential against the stacked adjoint
       (Q per sample equal to 1e-3 relative, iterations, ms per step, K1
       launches; K1 solves two right-hand sides per table set there); the
       structured against the gather coefMG on levels 1 and 2 (Q per sample
       to 1e-3, iterations within 2, ms of both, the gather's peak memory).
       At rtol 1e-4 with a bfloat16 preconditioner state Q is only as sharp
       as the solver's tolerance leaves it, so both comparisons are made
       again with a float32 state at rtol 1e-5, where Q must agree to 1e-5;
       "cg-schur" with the static multigrid, its line smoother and the local
       scaling on every level (iterations, converged fraction, ms: reported,
       only finite Q required - this is the preconditioner the per-sample
       coefMG replaced), and K1 with R = batch on the level-1 grid's static
       line tables against its plain version; minres-bj against cg-schur on
       the 64^3 box (float64, batch 4, rtol 1e-9: Q per sample to 1e-6,
       both iteration counts) on a mild field (log-std 0.2): on the golden
       field (variance 1) 40 000 MINRES iterations (85 s on an H100) do not
       reach the 2-norm target (PERF.md).
14. sharded golden MLMC - the golden config (float32, Darcy rtol 1e-5)
             under an explicit SampleMesh(4) in this one process, global
             batch 512: each level's per-sample q and qc equal the
             concatenation of four unsharded level steps at batch 128 keyed
             fold_in(key, i) (bit for bit, or within SHARD_RTOL relative to
             max |q|: the line says which); then an adaptive run() with its
             estimate within 0.25 of 2.56, launches of K1 and K2 printed;
             then M(w)^{-1} (K1) and K2 against their plain versions on every
             level at one shard's batch (128), float32.
             torch.cuda.device_count() is printed; the torch.distributed
             execution (one shard per rank, all_gather) is covered by the
             CPU test with two gloo processes only, and the line says so.
15. unstructured MLMC, agglomerated - the 6-tet unit cube refined 4 times
             (24 576 tets, 50 688 faces), box sides labelled, agglomerated 4
             levels deep with coarsening factor 8: cells and faces per level,
             host setup seconds; UNSTRUCTURED settings (batch 128, float32,
             minres-coefmg at rtol 1e-5, eff_perm, variance 0.25,
             correlation length 0.3, 800 iterations: the defaults of
             examples/unstructured_performance.py). Per level the step of
             an MLMC batch (eval_pair + solve_fwd_pair; the coarsest level
             one solve): samples/s, mean iterations, converged fraction
             (at least UNSTRUCTURED_MIN_CONVERGED); then MLMCManager.init_run of two batches per level
             (consistency < 0.1, finite estimate, K2 launched); one sample's
             level-0 Q against a float64 scipy spsolve of the same saddle
             system built on the host from the same w (UNSTRUCTURED_ORACLE_RTOL);
             K2 against its plain version at (128, 24 576) float32.
16. unstructured pair step, nested, full width - the cube refined 3 times
             as the coarsest of a 3-level nested hierarchy (196 608 / 24 576 /
             3072 tets, ~6e5 Darcy dofs at level 0): the level-0 pair step at
             batch 32, float32, minres-coefmg: samples/s, iterations,
             converged fraction (1.0 required), device-busy share (the
             profiler's kernel time over the synchronized wall of an
             unprofiled step, device_busy), peak memory; K2 against its
             plain version at (32, 196 608).
17. hybrid-cg, agglomerated (A) - phase 15's hierarchy and sampler under
             darcy_solver.name "hybrid-cg" (physics/hybrid.py: PCG on the
             face multipliers with Jacobi, constant-mode deflation and the
             graph coefMG as auxiliary-space cycle): which levels hybridize
             geometrically, algebraically or keep MINRES
             (HYBRID_AGGLOMERATED_KINDS, the JAX package's choice); per level
             samples/s, fine/coarse iterations, converged fraction (1.0
             required), device-busy share, peak memory, and Q/Qc per sample
             against minres-coefmg on the same fields and against a deep
             float64 hybrid-cg solve (HYBRID_Q_RTOL: max and median);
             phase 15's level-0 oracle sample against its spsolve
             (UNSTRUCTURED_ORACLE_RTOL; the direct solve is not repeated);
             MLMCManager.init_run of two batches per level (consistency <
             0.1, K2 launched).
18. hybrid-cg, nested (B) - phase 16's level-0 pair step under hybrid-cg:
             samples/s, iterations, converged fraction (1.0 required), busy
             share, kernels and device ms per PCG iteration of the Darcy pair
             alone and its four costliest kernels, peak memory, printed
             beside phase 16's MINRES numbers.
19. mesh files (C) - build_problem on MFEM v1.0 files written into a
             temporary directory (MESH_FILES): the coarsest tet cube refined
             to 24 576 tets with the plain SPDE sampler; that hierarchy's
             finest mesh as a file with unstructured_coarsening; a matching
             "_embed.mesh" (196 608 embedded tets at level 0) and a
             non-matching "_enlarge.mesh" (82 944) for projection_order 0
             and 1; all under hybrid-cg. Per configuration: the g++ build of
             the native geometry library (first use), host setup
             (build_problem, mortar assembly included), one MLMC batch of
             32 per level
             (finite estimate, every level hybridized, K2 launched); K2
             against its plain version at each embedded draw shape; the
             order-0 projection sampler on the matching embedding against
             the matching sampler (EMBED_AGREE_TOL).
Beside every M(w)^{-1} check of phases 8 and 9b, K1 also solves R = 2
right-hand sides per table set on the same tables against its plain
version (bound: tables once, b and x twice).

K2 and K3 at (512, 4096) are also read by device time: a CUDA graph of
GRAPH_LAUNCHES launches into one buffer, replayed, timed with CUDA events
(ms per launch without the host's launch path between the kernels).

Bounds (bound_ms, the least time the card could take for the same work):
K1 moves 5 words per unknown (reads dl, d, du and the right-hand side,
writes the solution; its c and g scratch never leaves the SM) over the
card's 3.35 TB/s. K2 and K3 write 4 or 8 bytes per element but are bound
by integer work: the instructions per element, counted by pipe in the SASS
of the built library (cuobjdump -sass), over that pipe's lanes per SM x the
SMs x the card's maximum SM clock (nvidia-smi clocks.max.sm); the busiest
pipe (the INT32 one) sets the bound. A float32 normal draw is held to the
uniform draw's count, the work every element does before erfinv; a float64
normal draw to the instructions of its own executed path (the common erfinv
branch, see executed_path): the busiest pipe over them or, if larger, all of
them over the SM's dispatch width.

Then one JSON line with the kernels' numbers (launches of each path with
the counts at 0 before it, `launches` being the ratio full-grid run's;
errors, ms, plain_ms, bound_ms and library_ms at the full-grid shapes for
K1 and K2, which the MLMC and the ratio run share, of sample_uniforms for
K3), the card's
name and power limit, and as the last line {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line; without a CUDA card, or
without the package beside this script, it exits non-zero and prints no
result. It also fails if the JAX package or jax was imported.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# rel. to max |z|: the kernel's order of operations (FMA, the segments of
# the contiguous axis) against the plain recurrence's.
F32_TOL_K1, F64_TOL_K1 = 1e-5, 1e-12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
# The Mode enum of csrc/threefry_normal.cu, in order.
THREEFRY_MODES = ("kNormalF32", "kNormalF64", "kBits32", "kBits64", "kUniformF32", "kUniformF64")
# SASS opcodes by the pipe of a Hopper SM partition that issues them, and
# that pipe's lanes per SM (4 partitions: 16 INT32, 32 FP32 of which 16 also
# run IMAD, 16 FP64, 4 MUFU lanes each; the architecture white paper).
PIPES = {
    "int": ("IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP", "IMNMX",
            "VIMNMX", "IABS", "PRMT", "SEL", "POPC", "FLO", "BREV", "BMSK", "SGXT"),
    "imad": ("IMAD", "IMUL", "IDP"),
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL"),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP"),
    "mufu": ("MUFU",),
}
PIPE_LANES = {"int": 64, "imad": 64, "fp32": 128, "fp64": 64, "mufu": 16}
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
BIG_REPS = 2  # timed 64^3 pair steps (the first includes warm-up)
K3_SHAPE = (512, 4096)
# Line solves of the coefMG smoother: f32 like K1's f32 tolerance; bf16
# rounds each step as the plain version's float32 ops do (no FMA), so the
# two agree bit for bit - one bf16 ulp (2^-8) of slack relative to max |x|.
F32_TOL_LINES, BF16_TOL_LINES = 1e-5, 2.0 ** -8
SPE10_ANCHOR = dict(estimate=361.882, est_tol=0.5, eq=(330.433, 308.151, 298.182),
                    eq_rtol=2e-3, dofs=[17280, 2272, 312])
# Launches per CUDA graph and replays, for the device time of a small draw.
GRAPH_LAUNCHES, GRAPH_REPLAYS = 200, 10
SAMPLER_BATCH = 512
SAMPLER_CASES = (("matching", dict(embedding="matching")),
                 ("projection", dict(embedding="projection")),
                 ("analytic", dict(sampler_name="analytic")),
                 ("matern", dict(sampler_name="matern")))
# Matching selection against mortar projection on one embedded mesh, float32.
EMBED_AGREE_TOL = 1e-4
# Three wells at mid-depth along the long axis (ft), local averages of
# radius 30 ft (examples/spe10_ratio_mlmc.py).
OBS_COORDS = (300.0, 550.0, 85.0, 600.0, 1100.0, 85.0, 900.0, 1650.0, 85.0)
OBS_EPS = 30.0
# tests/test_nondyadic.py:115-131. The pin comes from solves cut at 500
# iterations (both levels run to the limit), so it holds the unconverged
# iterates of the reference's float64 CG, which another package's rounding
# moves by about 1e-3 (the port reads 99934.08 on an H100): rtol 3e-3 here
# against 1e-3 there.
EGG = dict(estimate=99835.47, rtol=3e-3, embedded=[(64, 64, 11), (32, 32, 5)])
RATIO_ANCHOR = dict(ratio=354.436, splitting=350.767, rtol=2e-3)
# Phase 13a: (label, darcy_solver options, sampler_solver.coarse_dense_cutoff
# or None for the default) on the scaled SPE10 grid. The static multigrid is
# one dense inverse at that grid's 4096 cells under the default cutoff, so
# the line-smoother case lowers it to give the hierarchy levels (and K1 the
# static line tables with R = batch). cg-schur-exact runs with the local
# sqrt(w kinv) scaling: under the geometric-mean one it needs ~43 000
# iterations a solve at this contrast, as minres-bj does, and one such
# solver in the phase is enough. minres-bj takes ~52 000 iterations a
# level-0 solve there (its S(1) preconditioner sees nothing of the
# kinv_ref's contrast): 3.2 to 5.6 minutes for the anchor's run on an H100,
# with the host's speed, the longest case of the script, and half as much
# again for a level-0 cold solve, which phase_minres_scaled no longer makes
# (MINRES_SCALED_LEVELS).
SOLVER_CASES = (
    ("cg-schur static MG", dict(name="cg-schur"), None),
    ("cg-schur static MG local scaling", dict(name="cg-schur", local_schur_scaling=True), None),
    ("cg-schur static MG line smoother", dict(name="cg-schur", mg_line_smoother=True,
                                              local_schur_scaling=True), 500),
    ("cg-schur-diag", dict(name="cg-schur-diag"), None),
    ("cg-schur-exact local scaling", dict(name="cg-schur-exact", local_schur_scaling=True), None),
    ("cg-schur-coefmg gather", dict(name="cg-schur-coefmg", coefmg_impl="gather"), None),
    ("minres-bj", dict(name="minres-bj"), None),
)
SOLVER_MAXIT = 80_000
RATIO_ANCHOR_CG_SCHUR_RTOL = 1e-3  # the pins were taken on cg-schur
# Phase 13b, Q per sample of two solves that differ in the form of the
# solver alone (stacked against sequential adjoint; gather against structured
# coefMG). At the production settings (rtol 1e-4, bfloat16 preconditioner
# state) each Q is only as sharp as its solve: they differ by up to 9e-4
# (stacked, level 1, where the stacked loop's primal runs on after its
# tolerance until the adjoint has met its own) and 3e-4 (gather). TIGHT is
# the same comparison with a float32 state at rtol 1e-5, where the
# adjoint-corrected Q of either form is sharp to 2e-6 and less (measured).
PRODUCTION_Q_RTOL = 1e-3
TIGHT_SETTINGS = dict(coefmg_prec_dtype="", relative_tolerance=1e-5)
TIGHT_Q_RTOL = 1e-5
MINRES_Q_RTOL = 1e-6  # minres-bj against cg-schur on the 64^3 box, Q per sample
# The same on the scaled SPE10 grid at rtol 1e-8: at that contrast the flux
# QoI carries 4 (level 2) to 4000 (level 0) x the relative residual MINRES
# stops at (3.9e-8, 6.0e-7 and 4.1e-5 measured on levels 2, 1, 0).
MINRES_SCALED_Q_RTOL = 1e-4
# The levels of that comparison. Level 0 (a cold minres-bj solve of 53 201
# iterations, 95-170 s on an H100, host-bound) was cut to keep the script
# under ~900 s with the unstructured phases; the scaled anchor's MLMC run
# under minres-bj still solves level 0 and its estimate is checked.
MINRES_SCALED_LEVELS = (1, 2)
# The scaled anchor's MLMC run under minres-bj takes levels 1 and 2 only (the
# same keys as the other cases' runs; E[Y] held to theirs): its level-0
# solves (~52 000 iterations each, 3-6 minutes of the script) were cut to
# make room for the hybrid and mesh-file phases.
MINRES_SCALED_SAMPLES = [0, 32, 32]
# minres-bj against cg-schur on the 64^3 box (float64, batch 4, rtol 1e-9). On
# the golden field (variance 1) its block-diagonal preconditioner leaves
# MINRES short of rtol 1e-7 after 40 000 iterations (85 s on an H100, Q
# equal to 3e-7 by then; PERF.md), so the comparison takes a mild field
# (log-std 0.2), where both solvers converge in hundreds of iterations.
MINRES_BOX = dict(refinements=4, batch=4, rtol=1e-9, variance=0.04, maxit=5_000)
SPE10_DOFS = [4_525_000, 563_580, 71_595]
SPE10_CELLS = [1_122_000, 138_600, 17_325]
# Phase 14: shards in one process, global batch, and the agreement of the
# sharded step with four unsharded steps if not bit for bit (relative to max |q|).
SHARDS, SHARD_BATCH, SHARD_RTOL = 4, 512, 1e-6
# Phases 15-16, examples/unstructured_performance.py's defaults.
UNSTRUCTURED = dict(refine=4, levels=4, coarsening_factor=8, batch=128, rtol=1e-5, maxit=800,
                    variance=0.25, corlen=0.3, solver="minres-coefmg")
# Least converged fraction of a level's steps. MINRES (ops/solvers.minres,
# as the reference's) stops a row whose preconditioned residual estimate met
# the target but whose 2-norm residual still misses it after three restart
# cycles, far below the budget: on these agglomerated levels 1-6 % of the
# samples end so, in float32 and float64 alike, the same samples in both
# packages (PERF.md, PR 6); the JAX package's run of this configuration
# recorded 0.99609375 at level 0 too (UNSTRUCTURED_EVIDENCE.json, variants).
# Its production solver there, hybrid-cg, is ROADMAP item 15c.
UNSTRUCTURED_MIN_CONVERGED = 0.9
UNSTRUCTURED_FINE = (24_576, 50_688)  # cells, faces of the cube refined 4 times (6 * 8^4 tets)
UNSTRUCTURED_SAMPLES = 256  # init_run samples per level: two batches
UNSTRUCTURED_ORACLE_RTOL = 1e-4  # f32 device Q at rtol 1e-5 against the f64 direct solve
NESTED = dict(refine=3, levels=3, batch=32, cells=[196_608, 24_576, 3072])
# Phase 17: the per-level hybridization the JAX package makes on phase 15's
# hierarchy, and the limits of Q/Qc per sample of hybrid-cg against
# minres-coefmg on the same fields and against a deep float64 hybrid-cg solve
# (max and median over the batch of |diff| / max |Q|). At rtol 1e-5 the CG on
# the multiplier system leaves Q errors with a long tail: a median of ~1e-5
# and a maximum up to ~1e-3 at this size, in float64 as in float32 and in the
# JAX package's solve as in the port's (the tolerance's, not the precision's;
# the phase prints the float64 solve at rtol 1e-5 beside it).
HYBRID_AGGLOMERATED_KINDS = ["geometric", "algebraic", "algebraic", "algebraic"]
HYBRID_Q_RTOL = dict(max=1e-2, median=1e-4)
HYBRID_TRUTH = dict(rtol=1e-10, maxit=5000)
# Phase 19: the coarsest file (2^3 hexes of the unit cube in six tets each,
# refined 3 times: 24 576 tets at level 0), its matching embedding (4^3 hexes
# of [-0.5, 1.5]^3, the same spacing, material 1 inside the unit cube) and a
# non-matching enlargement (3^3 hexes of [-0.25, 1.25]^3): (hexes per axis,
# origin, side). One MLMC batch a level, hybrid-cg.
MESH_FILES = dict(levels=4, batch=32, coarse=(2, 0.0, 1.0), embed=(4, -0.5, 2.0),
                  enlarge=(3, -0.25, 1.5))
# The host assemblers of the projection sampler's mortar couplings (names in
# parelagmc_tpu_torch/unstructured.py), timed inside build_problem.
MORTAR_ASSEMBLERS = ("mortar_p0_couple", "mortar_p1_p0_couple")
MESH_FILE_CASES = (("plain", {}),
                   ("agglomerated", dict(unstructured_coarsening=True, coarsening_factor=8)),
                   ("matching", dict(embedding="matching")),
                   ("projection-0", dict(embedding="projection")),
                   ("projection-1", dict(embedding="projection", projection_order=1)))
# Six tets around the main diagonal of the unit cube (corners numbered x
# fastest, then y, then z): the shape and counts of the reference's
# cube_tet.mesh, which is not in the repository.
TET_SPLIT = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


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


def graph_ms(launch, launches: int = GRAPH_LAUNCHES, replays: int = GRAPH_REPLAYS) -> float:
    """Device milliseconds per call of `launch` (a wrapper launching its
    kernel on the current stream into a preallocated `out`): `launches` calls captured
    into one CUDA graph, the graph replayed `replays` times between two
    CUDA events. Nothing of the host's launch path sits between the
    kernels."""
    import torch

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def mass_tables(refinements: int, batch: int, dtype, device):
    """The M(w)^{-1} solver of build_problem's finest level at
    `refinements`, its factor tables for one batch of the sampler's own
    coefficient field, and a random right-hand side (batch, n_u)."""
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem

    cfg = ProblemConfig(refinements=refinements, batch_size=batch,
                        dtype=str(dtype).replace("torch.", ""))
    prob = build_problem(cfg, device=device)
    level = prob.solver.levels[0]
    w = prob.sampler.eval(0, prob.sampler.sample(0, PRNGKey(refinements), batch))
    fac = level.mass_solver.factor(w)
    return level.mass_solver, fac, random_rhs(fac, refinements), level


def random_rhs(fac, seed: int):
    """A random right-hand side of the factor tables' (B, n_u) shape."""
    import torch

    d = fac[1]
    g = torch.Generator(device=d.device).manual_seed(seed)
    return torch.randn(d.shape, generator=g, device=d.device, dtype=d.dtype)


def k1_bytes(n_unknowns: int, itemsize: int) -> int:
    """The bytes K1 must move: dl, d, du and the right-hand side read once,
    the solution written once (c and g stay on the SM)."""
    return 5 * n_unknowns * itemsize


def bytes_bound_ms(nbytes: int) -> float:
    return 1e3 * nbytes / HBM_BYTES_PER_S


def k1_check(ms_, fac, rhs, tol: float, label: str, plain_reps: int = 5):
    """M(w)^{-1} through K1 (apply_factored on CUDA tensors) against its
    plain composed version on one factor: a dict with the max error
    relative to max |z|, the max abs error, kernel, plain and bound ms per
    apply, and per axis (kernel ms, bound ms). Fails above `tol`."""
    import torch

    from parelagmc_tpu_torch.ops.tridiag_pallas import thomas_lines

    z = ms_.apply_factored(fac, rhs)
    ref = ms_.apply_plain(fac, rhs)
    torch.cuda.synchronize()
    if not torch.isfinite(z).all():
        fail(f"K1 non-finite output at {label}")
    abs_err = (z - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    if not rel <= tol:
        fail(f"K1 {label}: rel err {rel} > {tol}")
    kernel_ms = cuda_ms(lambda: ms_.apply_factored(fac, rhs))
    plain_ms = cuda_ms(lambda: ms_.apply_plain(fac, rhs), reps=plain_reps)
    axes = []
    for lay in ms_.layouts(rhs.shape[0]):
        axes.append((cuda_ms(lambda: thomas_lines(*fac, rhs, z, lay)),
                     bytes_bound_ms(k1_bytes(lay.n * lay.L, rhs.element_size()))))
    bound = bytes_bound_ms(k1_bytes(rhs.numel(), rhs.element_size()))
    return dict(rel=rel, abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                axes=axes)


def k1_line(label: str, r: dict, tol: float, gpu: str) -> str:
    axes = ", ".join(f"{ms:.4f}/{b:.4f}" for ms, b in r["axes"])
    return (f"{label}: max_rel_err {r['rel']:.3e} (tol {tol:g}) kernel {r['ms']:.4f} "
            f"plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} ms/apply "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound; per axis x, y, z kernel/bound ms "
            f"{axes}) [{gpu}]")


def k1_rhs_bytes(n_unknowns: int, rhs: int, itemsize: int) -> int:
    """The bytes K1 must move with `rhs` right-hand sides per table set: dl,
    d, du read once, each right-hand side read and each solution written
    once."""
    return (3 + 2 * rhs) * n_unknowns * itemsize


def k1_rhs_check(ms_, fac, tol: float, label: str, gpu: str, one_ms: float, R: int = 2,
                 plain_reps: int = 3):
    """M(w)^{-1} on (B, R, n_u): K1 with R right-hand sides per sample's
    tables (one launch per axis) against the plain composed version; prints
    and returns its numbers. `one_ms` is the same tables' single-vector
    apply, for the saving over R separate applies."""
    import torch

    d = fac[1]
    g = torch.Generator(device=d.device).manual_seed(R)
    rhs = torch.randn((d.shape[0], R, d.shape[1]), generator=g, device=d.device, dtype=d.dtype)
    z = ms_.apply_factored(fac, rhs)
    ref = ms_.apply_plain(fac, rhs)
    torch.cuda.synchronize()
    if not torch.isfinite(z).all():
        fail(f"K1 R={R} non-finite output at {label}")
    abs_err = (z - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    if not rel <= tol:
        fail(f"K1 R={R} {label}: rel err {rel} > {tol}")
    ms = cuda_ms(lambda: ms_.apply_factored(fac, rhs))
    plain_ms = cuda_ms(lambda: ms_.apply_plain(fac, rhs), reps=plain_reps)
    bound = bytes_bound_ms(k1_rhs_bytes(d.numel(), R, d.element_size()))
    print(f"{label}: K1 M(w)^-1 with R = {R} right-hand sides per table set: max_rel_err "
          f"{rel:.3e} (tol {tol:g}) kernel {ms:.4f} plain {plain_ms:.4f} bound {bound:.4f} "
          f"ms/apply ({100 * bound / ms:.1f}% of bound; {R} single applies {R * one_ms:.4f} ms: "
          f"x{R * one_ms / ms:.2f}) [{gpu}]", flush=True)
    return dict(R=R, rel=rel, abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound)


@functools.lru_cache(maxsize=None)
def threefry_sass():
    """{function name: [(address, predicated, opcode, branch target or None),
    ...]} of the built threefry library (cuobjdump -sass)."""
    from parelagmc_tpu_torch import kernels

    lib = kernels.library_path("threefry_normal.cu")
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {out.stderr.strip()}")
    return parse_sass(out.stdout)


def parse_sass(text: str):
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)(\S*)\s*([^;]*);",
                     line)
        if cur is not None and m:
            target = re.search(r"0x([0-9a-f]+)\s*$", m.group(5)) if m.group(3) == "BRA" else None
            cur.append((int(m.group(1), 16), bool(m.group(2)), m.group(3) + m.group(4),
                        int(target.group(1), 16) if target else None))
    return funcs


def threefry_function(mode: str):
    """The SASS of the threefry kernel in `mode` (the enum name in
    csrc/threefry_normal.cu, e.g. "kNormalF32")."""
    tag = f"threefry_kernelILNS_4ModeE{THREEFRY_MODES.index(mode)}E"
    hits = [k for k in threefry_sass() if tag in k]
    if len(hits) != 1 or not threefry_sass()[hits[0]]:
        fail(f"SASS of {mode}: functions {sorted(threefry_sass())}")
    return threefry_sass()[hits[0]]


def pipe_counts(insts):
    pipe_of = {op: pipe for pipe, ops in PIPES.items() for op in ops}
    counts = dict.fromkeys(PIPES, 0)
    for _, _, op, _ in insts:
        base = op.split(".")[0]
        if base in pipe_of:
            counts[pipe_of[base]] += 1
    return counts


@functools.lru_cache(maxsize=None)
def sass_counts(mode: str):
    """Instructions per element of the threefry kernel in `mode` by the pipe
    that executes them ({pipe: count}): a static count over the kernel's
    SASS in the built library. Every element runs the unrolled body once;
    the grid-stride loop's prologue is counted with it, and both branches
    of erfinv."""
    counts = pipe_counts(threefry_function(mode))
    if not any(counts.values()):
        fail(f"SASS of {mode}: no instruction of a known pipe")
    return counts


def executed_path(insts):
    """The SASS one element of a normal draw executes in the common case,
    separated like this: the kernel is cut into basic
    blocks at its branches and their targets; the loop body runs from the
    target of the one backward branch to that branch; among the paths
    through the body that avoid every block holding MUFU.RSQ64H, the longest
    is taken. erfinv's two tail branches (|log(1 - u^2)| >= 6.125, 0.1 % of
    uniform draws) are the only code that takes a reciprocal square root
    (directly or through the subroutine they CALL, which lies behind the
    EXIT), so avoiding them leaves the central branch and the short cuts
    for |u| >= 1, NaN and infinity, which the longest path leaves out too.
    The loop's prologue (before the body) is counted with the path, as in
    sass_counts."""
    addrs = [i[0] for i in insts]
    index = {a: k for k, a in enumerate(addrs)}
    # (The self-branch that pads the end of the function is no loop.)
    back = [(a, t) for a, _, op, t in insts if op == "BRA" and t is not None and t < a]
    if len(back) != 1:
        fail(f"executed_path: {len(back)} backward branches, expected the loop's one")
    tail_addr, head_addr = back[0]
    leaders = {addrs[0], head_addr}
    for k, (a, pred, op, t) in enumerate(insts):
        base = op.split(".")[0]
        if base in ("BRA", "EXIT", "RET") and k + 1 < len(insts):
            leaders.add(addrs[k + 1])
        if base == "BRA" and t in index:
            leaders.add(t)
    starts = sorted(leaders)
    blocks = {}
    for b, start in enumerate(starts):
        stop = starts[b + 1] if b + 1 < len(starts) else addrs[-1] + 1
        blocks[start] = [i for i in insts if start <= i[0] < stop]
    succ = {}
    for b, start in enumerate(starts):
        a, pred, op, t = blocks[start][-1]
        base = op.split(".")[0]
        nxt = starts[b + 1] if b + 1 < len(starts) else None
        out = []
        if base == "BRA":
            if t is not None and t > a:  # forward edges only: the body is a DAG
                out.append(t)
            if pred and nxt is not None:
                out.append(nxt)
        elif base in ("EXIT", "RET"):
            if pred and nxt is not None:
                out.append(nxt)
        elif nxt is not None:
            out.append(nxt)
        succ[start] = out
    last = max(s for s in starts if s <= tail_addr)
    banned = {s for s, blk in blocks.items() if any(i[2].startswith("MUFU.RSQ64H") for i in blk)}

    @functools.lru_cache(maxsize=None)
    def longest(start):
        if start in banned:
            return None
        if start == last:
            return (len(blocks[start]), (start,))
        best = None
        for nxt in succ[start]:
            sub = longest(nxt)
            if sub is not None and (best is None or sub[0] > best[0]):
                best = sub
        return None if best is None else (best[0] + len(blocks[start]), (start,) + best[1])

    path = longest(head_addr)
    if path is None:
        fail("executed_path: no path through the loop body avoids the erfinv tails")
    prologue = [i for i in insts if i[0] < head_addr]
    return prologue + [i for s in path[1] for i in blocks[s]]


DISPATCH_LANES = 128  # 4 warp schedulers x 1 instruction per clock x 32 lanes, per SM


@functools.lru_cache(maxsize=None)
def sm_clocks_per_s() -> float:
    """SMs x the maximum SM clock of this card (nvidia-smi clocks.max.sm)."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
                          "-i", "0"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm: {out.stderr.strip()}")
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def threefry_bound(mode: str, numel: int, itemsize: int):
    """(bound ms, bound_by) of one threefry draw: the larger of its
    instructions over the busiest pipe's lanes (per pipe: count per element
    / lanes per SM / (SMs x clock)) and its output bytes over 3.35 TB/s.
    A float32 normal draw is held to the work of the uniform draw of its
    width - the generator and the mantissa step, which every element runs -
    since a static count of its own SASS counts both branches of erfinv and
    so is no lower bound. A float64 normal draw is held to its own executed
    path (executed_path: the common erfinv branch, 99.9 % of draws): the
    busiest pipe over it - the FP64 one, with erfinv's polynomials - or,
    if larger, all its instructions over the SM's dispatch width."""
    if mode == "kNormalF64":
        path = executed_path(threefry_function(mode))
        counts = pipe_counts(path)
        per_elem = max(max(counts[p] / PIPE_LANES[p] for p in PIPES), len(path) / DISPATCH_LANES)
    else:
        counts = sass_counts(mode.replace("Normal", "Uniform"))
        per_elem = max(counts[p] / PIPE_LANES[p] for p in PIPES)  # SM clocks per element
    ops_ms = 1e3 * per_elem * numel / sm_clocks_per_s()
    byte_ms = bytes_bound_ms(numel * itemsize)
    return (ops_ms, "operations") if ops_ms >= byte_ms else (byte_ms, "bytes")


def bound_basis(mode: str) -> str:
    """What threefry_bound counted for `mode`, for the printed line."""
    if mode == "kNormalF64":
        path = executed_path(threefry_function(mode))
        return f"its executed path: {pipe_counts(path)}, {len(path)} instructions dispatched"
    return f"{sass_counts(mode.replace('Normal', 'Uniform'))}"


def k2_check(key, shape, dtype, device, tol: float, label: str, plain_reps: int = 5):
    """K2 against its plain version on one draw of `shape`: (kernel
    output, dict of max abs error, max |a-b|/(1+|b|), kernel, plain, bound
    and torch.randn ms). Fails above `tol`."""
    import torch

    from parelagmc_tpu_torch.ops import prng

    xk = prng.sample_normals(key, shape, dtype, device)
    xp = prng.normals_plain(key, shape, dtype, device)
    torch.cuda.synchronize()
    scaled = ((xk - xp).abs() / (1.0 + xp.abs())).max().item()
    abs_err = (xk - xp).abs().max().item()
    if not scaled <= tol:
        fail(f"K2 normals {label}: err {scaled} > {tol}")
    mode = "kNormalF32" if dtype == torch.float32 else "kNormalF64"
    bound, bound_by = threefry_bound(mode, xk.numel(), xk.element_size())
    buf = torch.empty_like(xk)
    return xk, dict(
        abs_err=abs_err, scaled=scaled, bound_ms=bound, bound_by=bound_by,
        ms=cuda_ms(lambda: prng.sample_normals(key, shape, dtype, device)),
        device_ms=graph_ms(lambda: prng.sample_normals(key, shape, dtype, device, out=buf)),
        plain_ms=cuda_ms(lambda: prng.normals_plain(key, shape, dtype, device), reps=plain_reps),
        # Philox: another generator, so not jax.random's values.
        library_ms=cuda_ms(lambda: torch.randn(shape, dtype=dtype, device=device)))


def k2_line(label: str, r: dict, tol: float, gpu: str) -> str:
    return (f"{label}: scaled_err {r['scaled']:.3e} (tol {tol:g}) kernel {r['ms']:.4f} "
            f"(events around calls) {r['device_ms']:.4f} (device, CUDA graph of {GRAPH_LAUNCHES} "
            f"launches: {100 * r['bound_ms'] / r['device_ms']:.1f}% of bound) "
            f"plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}) "
            f"torch.randn {r['library_ms']:.4f} ms [{gpu}]")


def path_kernel_checks(prob, batches, key, k1_tol: float, k2_tol: float, label: str, gpu: str):
    """M(w)^{-1} (K1) and K2 against their plain versions at the shapes a
    path gives them, on every level: K1 on the M(w)^{-1} tables factored
    for a sampled field at the level's batch, K2 on the level's noise draw.
    Returns {kernel: level-0 result dict, with max_abs_err the largest over
    the levels}."""
    import torch

    from parelagmc_tpu_torch.ops.prng import fold_in

    sampler, solver = prob.sampler, prob.solver
    dtype = solver.dtype
    name = str(dtype).replace("torch.", "")
    out = {}
    for level, batch in enumerate(batches):
        lkey = fold_in(key, level)
        shape = (batch, sampler.sample_size(level))
        _, k2 = k2_check(lkey, shape, dtype, solver.device, k2_tol,
                         f"{label} level {level} {name}")
        w = sampler.eval(level, sampler.sample(level, lkey, batch))
        ms_ = solver.levels[level].mass_solver
        fac = ms_.factor(w)
        k1 = k1_check(ms_, fac, random_rhs(fac, level), k1_tol, f"{label} level {level} {name}")
        print(k1_line(f"{label} level {level} batch {batch} {name}: K1 M(w)^-1 "
                      f"{ms_.shape} cells", k1, k1_tol, gpu), flush=True)
        k1["rhs2"] = k1_rhs_check(ms_, fac, k1_tol, f"{label} level {level} batch {batch} {name}",
                                  gpu, k1["ms"])
        del w, fac
        torch.cuda.empty_cache()
        print(k2_line(f"{label} level {level} {name}: K2 noise {shape}", k2, k2_tol, gpu),
              flush=True)
        for k, r, err in (("thomas", k1, max(k1["abs_err"], k1["rhs2"]["abs_err"])),
                          ("threefry_normal", k2, k2["abs_err"])):
            if k in out:
                out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err)
            else:
                out[k] = dict(r, max_abs_err=err)
    return out


def phase_k1(device, gpu: str):
    import torch

    for refinements, batch, label in K1_CASES:
        for dtype, tol in ((torch.float32, F32_TOL_K1), (torch.float64, F64_TOL_K1)):
            ms_, fac, rhs, lvl = mass_tables(refinements, batch, dtype, device)
            name = str(dtype).replace("torch.", "")
            r = k1_check(ms_, fac, rhs, tol, f"{label} {name}")
            print(k1_line(f"K1 M(w)^-1 {label} batch {batch} {name} ({lvl.n_u} faces/sample)",
                          r, tol, gpu), flush=True)
            del fac, rhs
            torch.cuda.empty_cache()


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
    for dtype, tol in ((torch.float32, F32_TOL_K2), (torch.float64, F64_TOL_K2)):
        name = str(dtype).replace("torch.", "")
        xk, r = k2_check(key, shape, dtype, device, tol, f"{shape} {name}")
        x64 = xk.double()
        mean, std = x64.mean().item(), x64.std().item()
        kurt = ((x64 - mean) ** 4).mean().item() / std ** 4
        mode = "kNormalF32" if dtype == torch.float32 else "kNormalF64"
        print(k2_line(f"K2 threefry normals {shape} {name} (bits32/64 identical, max_abs_err "
                      f"{r['abs_err']:.3e}, mean {mean:+.5f} std {std:.5f} kurtosis {kurt:.4f}, "
                      f"SASS per element {sass_counts(mode)}, bound from "
                      f"{bound_basis(mode)})", r, tol, gpu),
              flush=True)
        if not (abs(mean) < 0.01 and abs(std - 1.0) < 0.01 and abs(kurt - 3.0) < 0.05):
            fail(f"K2 normals {name}: moments off ({mean}, {std}, {kurt})")


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
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
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
    for rep in range(BIG_REPS):
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


def phase_k3(device, gpu: str):
    """K3 through its entry point (launches counted), then against its
    plain version: identical values, with no tolerance."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops import prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(0), 3), 1)
    dtypes = (torch.float32, torch.float64)
    kernels.reset_launch_counts()
    draws = [prng.sample_uniforms(key, K3_SHAPE, dt, device) for dt in dtypes]
    torch.cuda.synchronize()
    launches = kernels.launch_counts["threefry_uniform"]
    if launches != len(dtypes):
        fail(f"K3: sample_uniforms launched {launches} kernels for {len(dtypes)} draws")
    main_path = None
    for dt, xk in zip(dtypes, draws):
        xp = prng.uniforms_plain(key, K3_SHAPE, dt, device)
        name = str(dt).replace("torch.", "")
        if xk.dtype != dt or not torch.equal(xk, xp):
            fail(f"K3 uniforms {name} differ from the plain version")
        x64 = xk.double()
        mean, var = x64.mean().item(), x64.var().item()
        lo, hi = x64.min().item(), x64.max().item()
        mode = "kUniformF32" if dt == torch.float32 else "kUniformF64"
        bound, bound_by = threefry_bound(mode, xk.numel(), xk.element_size())
        buf = torch.empty_like(xk)
        r = dict(max_abs_err=0.0, bound_ms=bound, bound_by=bound_by,
                 ms=cuda_ms(lambda: prng.sample_uniforms(key, K3_SHAPE, dt, device)),
                 device_ms=graph_ms(lambda: prng.sample_uniforms(key, K3_SHAPE, dt, device,
                                                                 out=buf)),
                 plain_ms=cuda_ms(lambda: prng.uniforms_plain(key, K3_SHAPE, dt, device), reps=5),
                 # Philox: another generator, so not jax.random's values.
                 library_ms=cuda_ms(lambda: torch.rand(K3_SHAPE, dtype=dt, device=device)))
        print(f"K3 threefry uniforms {K3_SHAPE} {name}: identical to plain (tol 0) "
              f"mean {mean:.5f} var {var:.5f} (1/12 = {1 / 12:.5f}) min {lo:.3e} max {hi:.7f} "
              f"kernel {r['ms']:.4f} (events around calls) {r['device_ms']:.4f} (device, CUDA "
              f"graph of {GRAPH_LAUNCHES} launches: {100 * bound / r['device_ms']:.1f}% of bound) "
              f"plain {r['plain_ms']:.4f} bound {bound:.4f} ({bound_by}, "
              f"SASS per element {sass_counts(mode)}) torch.rand "
              f"{r['library_ms']:.4f} ms [{gpu}]", flush=True)
        if not (abs(mean - 0.5) < 0.005 and abs(var - 1 / 12) < 0.002 and 0.0 <= lo and hi < 1.0):
            fail(f"K3 uniforms {name}: moments off ({mean}, {var}, {lo}, {hi})")
        if dt == torch.float32:
            main_path = r
    return main_path, launches


def phase_spe10_anchor(device, gpu: str):
    """tests/test_spe10_anchor.py::test_spe10_scaled_anchor on the card."""
    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.physics.spe10 import SPE10_NCELLS, SPE10_SPACING, load_spe10_kinv
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg = ProblemConfig(mesh="box", ncells=tuple(g // 4 for g in grid), lengths=lengths,
                        refinements=2, correlation_length=100.0, dtype="float64", mse=1e10,
                        initial_samples=32, batch_size=16, seed=0, output_filename="",
                        cost_model="dofs")
    cfg.normalize_marginals = True
    cfg.darcy_solver.name = "cg-schur-coefmg"
    cfg.darcy_solver.relative_tolerance = 1e-8
    cfg.darcy_solver.max_iterations = 2000
    prob = build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=device)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mgr.init_run([32, 32, 32])
    dt = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    dofs = [prob.solver.num_dofs(l) for l in range(3)]
    eq = [float(x) for x in mgr.eQ]
    cons = float(mgr.consistency.max())
    print(f"SPE10 scaled anchor (16x32x8, f64, cg-schur-coefmg, rtol 1e-8): estimate "
          f"{mgr.estimate:.6f} (pin {SPE10_ANCHOR['estimate']}) E[Q] {[round(x, 4) for x in eq]} "
          f"dofs {dofs} consistency {cons:.4f} iterations {mgr.solver_iterations.tolist()} "
          f"run {dt:.2f} s launches {launches} [{gpu}]", flush=True)
    if dofs != SPE10_ANCHOR["dofs"]:
        fail(f"SPE10 anchor dofs {dofs}")
    if not abs(mgr.estimate - SPE10_ANCHOR["estimate"]) < SPE10_ANCHOR["est_tol"]:
        fail(f"SPE10 anchor estimate {mgr.estimate}")
    for got, pin in zip(eq, SPE10_ANCHOR["eq"]):
        if not abs(got - pin) <= SPE10_ANCHOR["eq_rtol"] * abs(pin):
            fail(f"SPE10 anchor E[Q] {eq} not within 2e-3 of {SPE10_ANCHOR['eq']}")
    if not cons < 0.1:
        fail(f"SPE10 anchor consistency {cons}")
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the SPE10 anchor run")
    checks = path_kernel_checks(prob, mgr.level_batch, fold_in(PRNGKey(cfg.seed), 98),
                                F64_TOL_K1, F64_TOL_K2, "SPE10 anchor kernels vs plain", gpu)
    return launches, checks


def spe10_full_problem(device):
    """The full-grid production problem of examples/spe10_mlmc.py and
    examples/spe10_ratio_mlmc.py (--refinements 2 --dtype float32, synthetic
    permeability)."""
    from parelagmc_tpu_torch.physics.spe10 import full_grid_solver_defaults, load_spe10_kinv
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem

    cfg = ProblemConfig(mesh="spe10", refinements=2, dtype="float32", correlation_length=100.0,
                        mse=-1.0, initial_samples=32, batch_size=32, normalize_marginals=True,
                        axis_order="auto", output_filename="",
                        # Read by the ratio run only (examples/spe10_ratio_mlmc.py);
                        # axis_order relabels the coordinates with the mesh.
                        bayes_num_obs=3, bayes_obs_coords=OBS_COORDS, bayes_eps=OBS_EPS,
                        bayes_generate_ref_data=True, bayes_ref_data_file="")
    full_grid_solver_defaults(cfg)
    kinv = load_spe10_kinv(None, ncells=(60, 220, 85))
    return build_problem(cfg, kinv_ref=kinv, device=device)


def phase_k1_lines(prob, device, gpu: str):
    """K1 on the line tables of the coefMG smoother: struct_mg_setup on a
    sampled full-grid level-1 field (production batch 128), line axes
    "auto", float32 and bfloat16 tables. An isolated check: the production
    settings leave coefmg_line_axes empty, so no run that this script
    drives end to end reaches the line smoother or the bf16 kernel."""
    import torch

    from parelagmc_tpu_torch.ops import coef_multigrid_structured as cmg
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.ops.tridiag_pallas import thomas, thomas_plain

    level, batch = 1, prob.config.batch_size_per_level[1]
    solver, sampler = prob.solver, prob.sampler
    mesh = prob.hierarchy.levels[level].mesh
    axes = cmg.parse_line_axes("auto", mesh, solver.kinv_levels[level])
    if not axes:
        fail("K1 lines: coefmg_line_axes 'auto' picked no axis on the SPE10 level-1 grid")
    mg = cmg.build_struct_coef_mg(mesh, cutoff=solver.solver_cfg.coarse_dense_cutoff,
                                  line_axes=axes)
    w = sampler.eval(level, sampler.sample(level, PRNGKey(11), batch))
    ms_ = solver.levels[level].mass_solver
    diag = ms_.masked_diag(ms_.factor(w), w.shape[:-1])
    dinv0 = torch.where(diag > 0, 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag)),
                        torch.zeros_like(diag))
    state = cmg.struct_mg_setup(mg, dinv0)
    g = torch.Generator(device=device).manual_seed(12)
    for dtype, tol in ((torch.float32, F32_TOL_LINES), (torch.bfloat16, BF16_TOL_LINES)):
        name = str(dtype).replace("torch.", "")
        tabs = cmg.cast_state(state, dtype)[0][2]
        for a, (dl, dd, du) in zip(axes, tabs):
            b = torch.randn(tuple(dd.shape), generator=g, device=device).to(dtype)
            xk = thomas(dl, dd, du, b)
            xp = thomas_plain(dl, dd, du, b)
            torch.cuda.synchronize()
            diff = (xk.float() - xp.float()).abs().max().item()
            rel = diff / xp.float().abs().max().item()
            if not torch.isfinite(xk.float()).all():
                fail(f"K1 lines non-finite output ({name}, axis {a})")
            ms = cuda_ms(lambda: thomas(dl, dd, du, b))
            plain_ms = cuda_ms(lambda: thomas_plain(dl, dd, du, b), reps=3)
            bound = bytes_bound_ms(k1_bytes(b.numel(), b.element_size()))
            print(f"K1 thomas coefMG line tables SPE10 level 1 {mesh.shape} batch {batch} "
                  f"axis {a} (n {dd.shape[0]}, lines {dd.numel() // dd.shape[0]}) {name}: "
                  f"max_rel_err {rel:.3e} (tol {tol:g}) kernel {ms:.4f} plain {plain_ms:.4f} "
                  f"bound {bound:.4f} ms/line solve ({100 * bound / ms:.1f}% of bound) [{gpu}]",
                  flush=True)
            if not rel <= tol:
                fail(f"K1 lines {name} axis {a}: rel err {rel} > {tol}")


def phase_spe10_full(prob, setup_s: float, device, gpu: str):
    """The production run on the full grid through MLMCManager, then one
    timed batch per level with the convergence canary."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops import coef_multigrid_structured as cmg
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg, solver, sampler = prob.config, prob.solver, prob.sampler
    cells = [sampler.sample_size(l) for l in range(3)]
    dofs = [solver.num_dofs(l) for l in range(3)]
    print(f"SPE10 full grid: host setup {setup_s:.2f} s, mesh {prob.hierarchy.levels[0].mesh.shape}"
          f" cells {cells} dofs {dofs} [{gpu}]", flush=True)
    if cells != SPE10_CELLS or dofs != SPE10_DOFS:
        fail(f"SPE10 full grid: cells {cells} dofs {dofs}")
    torch.cuda.reset_peak_memory_stats(device)
    mgr = MLMCManager(solver, sampler, cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mgr.init_run(list(cfg.batch_size_per_level))
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    print(mgr.show_me(), flush=True)
    print(f"SPE10 full grid init_run({cfg.batch_size_per_level}): {run_s:.2f} s (incl. one "
          f"discarded warm-up batch per level and the mean-field setup solves) C_l "
          f"{mgr.cost.tolist()} s/sample iterations {mgr.solver_iterations.tolist()} E[Q] "
          f"{mgr.eQ.tolist()} E[Y] {mgr.eY.tolist()} launches {launches} [{gpu}]", flush=True)
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the SPE10 full-grid run")
    budget = mgr.pair_budget  # the budget the manager gave each pair solve
    key = fold_in(PRNGKey(cfg.seed), 99)
    for level in range(3):
        batch = mgr.level_batch[level]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xi = sampler.sample(level, fold_in(key, level), batch)
        s_f = sampler.eval(level, xi)
        if level < 2:
            s_c = sampler.eval(level + 1, xi, xi_level=level)
            q, qc, info_f, info_c = solver.solve_fwd_pair(level, s_f, s_c, max_iters=budget)
            infos, limit = (info_c, info_f), 2 * budget  # primal + adjoint per member
        else:
            q, _, info = solver.solve_fwd(level, s_f)
            qc, infos, limit = torch.zeros_like(q), (info,), 2 * solver.solver_cfg.max_iterations
        q = q.double().cpu()
        qc = qc.double().cpu()
        dt = time.perf_counter() - t0
        conv = float(torch.cat([i.converged.float().cpu() for i in infos]).mean())
        its = [i.iterations for i in infos]
        print(f"SPE10 full grid level {level} timed batch {batch}: {dt:.3f} s "
              f"({1e3 * dt / batch:.2f} ms/sample) iterations {its} (limit {limit} each) "
              f"converged fraction {conv} E[Q] {float(q.mean()):.4f} "
              f"E[Y] {float((q - qc).mean()):.4f} [{gpu}]", flush=True)
        if conv < 1.0:
            fail(f"SPE10 full grid level {level}: converged fraction {conv}")
        if not (torch.isfinite(q).all() and torch.isfinite(qc).all()):
            fail(f"SPE10 full grid level {level}: non-finite Q")
        if not all(i < limit for i in its):
            fail(f"SPE10 full grid level {level}: iterations {its} at the budget {limit}")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    # Level-0 layer times at the production batch.
    L0 = solver.levels[0]
    w = sampler.eval(0, sampler.sample(0, fold_in(key, 7), mgr.level_batch[0]))
    fac = L0.mass_solver.factor(w)
    r = torch.randn(w.shape[:-1] + (L0.n_u,), device=device, dtype=w.dtype)
    minv_ms = cuda_ms(lambda: L0.mass_solver.apply_factored(fac, r), reps=10)
    diag = L0.mass_solver.masked_diag(fac, w.shape[:-1])
    dinv0 = torch.where(diag > 0, 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag)),
                        torch.zeros_like(diag))
    state = cmg.cast_state(cmg.struct_mg_setup(L0.coef_mg, dinv0), torch.bfloat16)
    b = torch.randn(w.shape, device=device, dtype=w.dtype)
    vc_ms = cuda_ms(lambda: cmg.struct_v_cycle(L0.coef_mg, state, b.to(torch.bfloat16)), reps=10)
    print(f"SPE10 full grid level 0 batch {mgr.level_batch[0]}: M(w)^-1 apply {minv_ms:.3f} ms, "
          f"coefMG V-cycle (cheb3, bf16 state, {len(L0.coef_mg.levels)} MG levels) "
          f"{vc_ms:.3f} ms (CUDA events); peak memory {peak_gb:.2f} GB [{gpu}]", flush=True)
    del w, fac, r, diag, dinv0, state, b
    checks = path_kernel_checks(prob, mgr.level_batch, fold_in(key, 8), F32_TOL_K1,
                                F32_TOL_K2, "SPE10 full grid kernels vs plain", gpu)
    return launches, checks


def solver_canary(prob, level: int, nsamples: int, key, max_iters=None):
    """One cold solve of `nsamples` sampled fields at `level`, as the
    likelihoods run it: (converged fraction, iterations, Q)."""
    xi = prob.sampler.sample(level, key, nsamples)
    w = prob.sampler.eval(level, xi)
    q, _, info, _ = prob.solver.solve_fwd(level, w, return_pressure=True, max_iters=max_iters)
    return float(info.converged.float().mean()), int(info.iterations), q


def phase_samplers(device, gpu: str):
    """Phase 10: the embedded, projection and KL samplers on the golden box,
    the projection sampler at 64^3, the Egg model."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    batch, f32 = SAMPLER_BATCH, torch.float32
    launches, seen_shapes, fields = {}, set(), {}
    for name, kw in SAMPLER_CASES:
        cfg = ProblemConfig(refinements=2, batch_size=batch, n_buffer=(1,), output_filename="",
                            **kw)
        cfg.darcy_solver.relative_tolerance = 1e-5
        t0 = time.perf_counter()
        prob = build_problem(cfg, device=device)
        setup_s = time.perf_counter() - t0
        sampler = prob.sampler
        for level in range(3):
            key = fold_in(PRNGKey(10), level)  # shared by the cases: the embedded ones compare
            shape = (batch, sampler.sample_size(level))
            if shape not in seen_shapes:
                seen_shapes.add(shape)
                _, k2 = k2_check(key, shape, f32, device, F32_TOL_K2, f"samplers {name} {shape}")
                print(k2_line(f"samplers {name} level {level}: K2 noise {shape} float32", k2,
                              F32_TOL_K2, gpu), flush=True)
            xi = sampler.sample(level, key, batch)
            outs = [sampler.eval(level, xi)]
            if level < 2:
                outs.append(sampler.eval(level + 1, xi, xi_level=level))
            for lv, s in zip((level, level + 1), outs):
                if tuple(s.shape) != (batch, prob.hierarchy.levels[lv].n_s):
                    fail(f"samplers {name}: eval on level {lv} has shape {tuple(s.shape)}")
                if not torch.isfinite(s).all():
                    fail(f"samplers {name}: non-finite field on level {lv}")
            fields[name, level] = outs
        mgr = MLMCManager(prob.solver, sampler, cfg)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        mgr.init_run([batch] * 3)
        run_s = time.perf_counter() - t0
        launches[name] = dict(kernels.launch_counts)
        conv = [solver_canary(prob, level, batch, fold_in(PRNGKey(11), level))[:2]
                for level in range(3)]
        print(f"samplers {name} ({type(sampler).__name__}, noise sizes "
              f"{[sampler.sample_size(l) for l in range(3)]}, setup {setup_s:.2f} s): "
              f"init_run {run_s:.2f} s estimate {mgr.estimate:.4f} E[Q] {mgr.eQ.tolist()} "
              f"iterations {mgr.solver_iterations.tolist()} canary (converged, iterations) {conv} "
              f"launches {launches[name]} [{gpu}]", flush=True)
        if not (np_isfinite(mgr.eQ) and math.isfinite(mgr.estimate)):
            fail(f"samplers {name}: non-finite E[Q] {mgr.eQ.tolist()}")
        if any(c < 1.0 for c, _ in conv):
            fail(f"samplers {name}: converged fraction {conv}")
        for k in ("thomas", "threefry_normal"):
            if launches[name][k] <= 0:
                fail(f"kernel {k} was not launched by the {name} MLMC round")
    worst = 0.0
    for level in range(3):
        for a, b in zip(fields["matching", level], fields["projection", level]):
            worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
    print(f"samplers: matching selection vs mortar projection on the common embedded mesh, "
          f"max rel diff {worst:.3e} (tol {EMBED_AGREE_TOL:g}) [{gpu}]", flush=True)
    if not worst <= EMBED_AGREE_TOL:
        fail(f"matching and projection samplers differ by {worst}")
    del fields

    # The projection sampler at 64^3 cells, 8 buffer cells a side.
    cfg = ProblemConfig(ncells=(8, 8, 8), refinements=3, embedding="projection", n_buffer=(1,),
                        dtype="float64", batch_size=BIG_BATCH, output_filename="")
    cfg.darcy_solver.local_schur_scaling = True
    prob = build_problem(cfg, device=device)
    sampler = prob.sampler
    eshape = prob.embed_hierarchy.levels[0].mesh.shape
    if prob.hierarchy.levels[0].mesh.shape != (64, 64, 64) or eshape != (80, 80, 80):
        fail(f"64^3 projection: meshes {prob.hierarchy.levels[0].mesh.shape} in {eshape}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    xi = sampler.sample(0, PRNGKey(12), BIG_BATCH)
    s = sampler.eval(0, xi)
    sc = sampler.eval(1, xi, xi_level=0)
    if not (torch.isfinite(s).all() and torch.isfinite(sc).all()):
        fail("64^3 projection: non-finite field")
    eval_ms = cuda_ms(lambda: sampler.eval(0, xi), reps=5)
    solve_ms = cuda_ms(lambda: sampler.embed_eval(0, xi), reps=5)
    coarse_ms = cuda_ms(lambda: sampler.eval(1, xi, xi_level=0), reps=5)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"projection sampler 64^3 in {eshape} (float64, batch {BIG_BATCH}, ELL width "
          f"{sampler.G[0].cols.shape[1]}): eval {eval_ms:.3f} ms (embedded solve alone "
          f"{solve_ms:.3f} ms), coupled coarse eval {coarse_ms:.3f} ms, peak memory "
          f"{peak_gb:.2f} GB [{gpu}]", flush=True)
    del prob, sampler, xi, s, sc
    torch.cuda.empty_cache()

    # The Egg model with the projection embedding (non-dyadic z = 7).
    cfg = ProblemConfig(mesh="egg", embedding="projection", refinements=1, dtype="float64",
                        seed=0, correlation_length=30.0, mse=1e10, initial_samples=16,
                        batch_size=16, output_filename="")
    prob = build_problem(cfg, device=device)
    shapes = [lvl.mesh.shape for lvl in prob.embed_hierarchy.levels]
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    t0 = time.perf_counter()
    mgr.init_run([16, 16])
    print(f"Egg model {prob.hierarchy.levels[0].mesh.shape} projection embedding, embedded "
          f"{shapes} (float64): estimate {mgr.estimate:.3f} (pin {EGG['estimate']}, rtol "
          f"{EGG['rtol']:g}) iterations {mgr.solver_iterations.tolist()} consistency "
          f"{mgr.consistency[:1].tolist()} run {time.perf_counter() - t0:.2f} s [{gpu}]", flush=True)
    if prob.hierarchy.levels[0].mesh.shape != (60, 60, 7) or shapes != EGG["embedded"]:
        fail(f"Egg meshes {prob.hierarchy.levels[0].mesh.shape} embedded {shapes}")
    if not abs(mgr.estimate - EGG["estimate"]) <= EGG["rtol"] * EGG["estimate"]:
        fail(f"Egg estimate {mgr.estimate}")
    if not (mgr.consistency[:1] < 1.0).all() or not np_isfinite(mgr.varY):
        fail(f"Egg consistency {mgr.consistency.tolist()} Var[Y] {mgr.varY.tolist()}")
    return launches


def np_isfinite(a) -> bool:
    return all(math.isfinite(float(x)) for x in a)


def phase_ratio_anchor(device, gpu: str, solver: str = "cg-schur-coefmg",
                       rtol: float = RATIO_ANCHOR["rtol"]):
    """Phase 11: tests/test_spe10_anchor.py's scaled ratio and splitting
    anchors on the card (both estimators read one moment table: the
    splitting run of the test draws the same stream), under `solver`; the
    pins were taken on "cg-schur" (phase 13a holds that run to `rtol`
    1e-3)."""
    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.physics.spe10 import SPE10_NCELLS, SPE10_SPACING, load_spe10_kinv
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager
    from parelagmc_tpu_torch.uq.ratio_managers import YRATIO, Z

    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    # Coarser cells than the real grid's: widen the radius to keep a cell in range.
    eps = max(OBS_EPS, 0.75 * max(L / n for L, n in zip(lengths, grid)))
    cfg = ProblemConfig(mesh="box", ncells=tuple(g // 2 for g in grid), lengths=lengths,
                        refinements=1, correlation_length=100.0, mse=1e10, initial_samples=8,
                        batch_size=8, normalize_marginals=True, axis_order="auto",
                        dtype="float64", bayes_num_obs=3, bayes_obs_coords=OBS_COORDS,
                        bayes_eps=eps, bayes_generate_ref_data=True, bayes_ref_data_file="",
                        output_filename="")
    cfg.darcy_solver.name = solver
    prob = build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=device)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype)
    mgr = BayesRatioManager(bip, prob.config)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    y = bip.generate_observational_data()
    mgr.init_run([8, 8])
    dt = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    ratio, splitting = mgr.estimate, float(mgr.E[:, YRATIO].sum())
    ez = mgr.E[:, Z].tolist()
    print(f"SPE10 scaled ratio anchor (16x32x8, f64, {solver}, rtol 1e-6): observation "
          f"data {y.tolist()} ratio estimate {ratio:.6f} (pin {RATIO_ANCHOR['ratio']}) splitting "
          f"estimate {splitting:.6f} (pin {RATIO_ANCHOR['splitting']}) samples "
          f"{mgr.level_nsamples.tolist()} E[Z] {ez} run {dt:.2f} s launches {launches} [{gpu}]",
          flush=True)
    for name, got in (("ratio", ratio), ("splitting", splitting)):
        if not abs(got - RATIO_ANCHOR[name]) <= rtol * RATIO_ANCHOR[name]:
            fail(f"ratio anchor ({solver}): {name} estimate {got} not within {rtol:g} of "
                 f"{RATIO_ANCHOR[name]}")
    if mgr.level_nsamples.tolist() != [8, 8] or not min(ez) > 0.01:
        fail(f"ratio anchor: samples {mgr.level_nsamples.tolist()} E[Z] {ez}")
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the ratio anchor run")
    return launches


def phase_ratio_full(prob, device, gpu: str):
    """Phase 12: examples/spe10_ratio_mlmc.py --refinements 2 on the full
    grid, one batch per level."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager
    from parelagmc_tpu_torch.uq.ratio_managers import YRATIO, Z

    cfg = prob.config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    mgr = BayesRatioManager(bip, cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    y = bip.generate_observational_data()
    obs_s = time.perf_counter() - t0
    print(f"SPE10 ratio full grid: wells {cfg.bayes_obs_coords} (mesh axes) radius "
          f"{cfg.bayes_eps} ft, cells per functional "
          f"{[int((g > 0).sum()) for g in bip.g_obs[0]]}, observation data y = {y.tolist()} "
          f"({obs_s:.2f} s) [{gpu}]", flush=True)
    budget = mgr.solve_budget
    for level in range(cfg.nlevels):
        conv, its, q = solver_canary(prob, level, 8, PRNGKey(99 + level), max_iters=budget)
        print(f"SPE10 ratio full grid canary level {level}: converged fraction {conv} "
              f"iterations {its} (budget {budget} each for primal and adjoint) "
              f"E[Q] {float(q.double().mean()):.4f} [{gpu}]", flush=True)
        if conv < 1.0:
            fail(f"SPE10 ratio full grid canary level {level}: converged fraction {conv}")
    t0 = time.perf_counter()
    mgr.init_run(list(cfg.batch_size_per_level))
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    ratio, splitting = mgr.estimate, float(mgr.E[:, YRATIO].sum())
    print(mgr.show_me(), flush=True)
    print(f"SPE10 ratio full grid init_run({cfg.batch_size_per_level}): {run_s:.2f} s (incl. one "
          f"discarded warm-up batch per level) ratio estimate {ratio:.6f} splitting estimate "
          f"{splitting:.6f} C_l {mgr.cost.tolist()} s/sample E[Z] {mgr.E[:, Z].tolist()} "
          f"launches {launches} peak memory {peak_gb:.2f} GB [{gpu}]", flush=True)
    if not (math.isfinite(ratio) and math.isfinite(splitting)):
        fail(f"SPE10 ratio full grid: estimates {ratio}, {splitting}")
    if mgr.level_nsamples.tolist() != list(cfg.batch_size_per_level):
        fail(f"SPE10 ratio full grid: samples {mgr.level_nsamples.tolist()}")
    if not (mgr.E[:, Z] > 0).all():
        fail(f"SPE10 ratio full grid: E[Z] {mgr.E[:, Z].tolist()}")
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the SPE10 ratio run")
    return launches


def scaled_spe10_problem(solver_opts: dict, sampler_cutoff, device):
    """The scaled SPE10 anchor's problem (phase 8) under other Darcy
    solver options."""
    from parelagmc_tpu_torch.physics.spe10 import SPE10_NCELLS, SPE10_SPACING, load_spe10_kinv
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem

    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg = ProblemConfig(mesh="box", ncells=tuple(g // 4 for g in grid), lengths=lengths,
                        refinements=2, correlation_length=100.0, dtype="float64", mse=1e10,
                        initial_samples=32, batch_size=16, seed=0, output_filename="",
                        cost_model="dofs")
    cfg.normalize_marginals = True
    cfg.darcy_solver.relative_tolerance = 1e-8
    cfg.darcy_solver.max_iterations = SOLVER_MAXIT
    for k, v in solver_opts.items():
        setattr(cfg.darcy_solver, k, v)
    if sampler_cutoff is not None:
        cfg.sampler_solver.coarse_dense_cutoff = sampler_cutoff
    return build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=device)


def phase_minres_scaled(device, gpu: str):
    """minres-bj against cg-schur (static MG, local scaling) on the levels
    MINRES_SCALED_LEVELS of the scaled SPE10 grid: one cold solve of 16
    samples each (the canaries of phase_solvers_scaled), the same Q per
    sample and both converged 1.0."""
    import torch

    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    probs = [scaled_spe10_problem(opts, None, device)
             for opts in (dict(name="cg-schur", local_schur_scaling=True),
                          dict(name="minres-bj"))]
    for level in MINRES_SCALED_LEVELS:
        w = probs[0].sampler.eval(level, probs[0].sampler.sample(level, fold_in(PRNGKey(13), level),
                                                                 16))
        (q1, _, i1), (q2, _, i2) = (p.solver.solve_fwd(level, w) for p in probs)
        rel = ((q2 - q1).abs() / q1.abs()).max().item()
        print(f"solvers scaled grid level {level} (f64, rtol 1e-8, 16 samples) cg-schur vs "
              f"minres-bj: max rel Q diff {rel:.3e} (tol {MINRES_SCALED_Q_RTOL:g}) iterations "
              f"{i1.iterations} vs {i2.iterations} converged "
              f"{float(i1.converged.float().mean())} / {float(i2.converged.float().mean())} "
              f"[{gpu}]", flush=True)
        if not (torch.isfinite(q2).all() and rel <= MINRES_SCALED_Q_RTOL):
            fail(f"minres-bj on the scaled grid level {level}: Q differs from cg-schur's by {rel}")
        if not (bool(i1.converged.all()) and bool(i2.converged.all())):
            fail(f"minres-bj / cg-schur on the scaled grid level {level}: not converged")


def phase_solvers_scaled(device, gpu: str):
    """Phase 13a: the scaled SPE10 MLMC anchor (16x32x8, float64, rtol 1e-8:
    deep enough that the estimate does not depend on the solver) under every
    Darcy solver of SOLVER_CASES: estimate within 0.5 of 361.882, and one cold
    solve of 16 samples per level converged 1.0 (minres-bj makes these
    solves in phase_minres_scaled, beside cg-schur's). Returns {label:
    launches of the run}."""
    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager

    launches = {}
    first = None
    for label, opts, cutoff in SOLVER_CASES:
        t0 = time.perf_counter()
        prob = scaled_spe10_problem(opts, cutoff, device)
        setup_s = time.perf_counter() - t0
        mgr = MLMCManager(prob.solver, prob.sampler, prob.config)
        minres = opts["name"] == "minres-bj"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        mgr.init_run(MINRES_SCALED_SAMPLES if minres else [32, 32, 32])
        run_s = time.perf_counter() - t0
        launches[label] = dict(kernels.launch_counts)
        if first is None:
            first = mgr
        if minres:
            # Levels 1-2 only (the same keys as every case's run): their
            # E[Y] against the first case's, to MINRES_SCALED_Q_RTOL of E[Q].
            diff = [abs(mgr.eY[l] - first.eY[l]) / abs(first.eQ[l]) for l in (1, 2)]
            print(f"solvers scaled anchor [{label}] (16x32x8, f64, rtol 1e-8, setup "
                  f"{setup_s:.2f} s): init_run({MINRES_SCALED_SAMPLES}) E[Y_1], E[Y_2] "
                  f"{mgr.eY[1]:.6f}, {mgr.eY[2]:.6f} against [{SOLVER_CASES[0][0]}] "
                  f"{first.eY[1]:.6f}, {first.eY[2]:.6f}: rel to E[Q] {diff} (tol "
                  f"{MINRES_SCALED_Q_RTOL:g}) iterations {mgr.solver_iterations.tolist()} run "
                  f"{run_s:.2f} s launches {launches[label]} [{gpu}]", flush=True)
            if not all(d <= MINRES_SCALED_Q_RTOL for d in diff):
                fail(f"solvers scaled anchor [{label}]: E[Y] of levels 1-2 off by {diff}")
            if launches[label]["threefry_normal"] <= 0:
                fail(f"kernel threefry_normal was not launched by the scaled anchor under {label}")
            continue
        levels = (0, 1, 2)
        canary = [solver_canary(prob, level, 16, fold_in(PRNGKey(13), level))[:2]
                  for level in levels]
        mg = prob.solver.levels[0].schur_mg
        shape = "" if mg is None else (
            f" static MG levels {len(mg.levels) + 1}, line smoothers on level 0 "
            f"{0 if not len(mg.levels) or mg.levels[0].line is None else len(mg.levels[0].line)};")
        print(f"solvers scaled anchor [{label}] (16x32x8, f64, rtol 1e-8, setup {setup_s:.2f} s):"
              f"{shape} estimate {mgr.estimate:.6f} (pin {SPE10_ANCHOR['estimate']}) iterations "
              f"{mgr.solver_iterations.tolist()} run {run_s:.2f} s canary on levels {levels} "
              f"(converged, iterations) {canary} launches {launches[label]} [{gpu}]", flush=True)
        if not abs(mgr.estimate - SPE10_ANCHOR["estimate"]) < SPE10_ANCHOR["est_tol"]:
            fail(f"solvers scaled anchor [{label}]: estimate {mgr.estimate}")
        if any(c < 1.0 for c, _ in canary):
            fail(f"solvers scaled anchor [{label}]: converged fraction {canary}")
        need = ["threefry_normal"] + ([] if opts["name"] == "minres-bj" else ["thomas"])
        for k in need:
            if launches[label][k] <= 0:
                fail(f"kernel {k} was not launched by the scaled anchor under {label}")
        if opts.get("mg_line_smoother") and (mg is None or not len(mg.levels)
                                             or mg.levels[0].line is None):
            fail(f"solvers scaled anchor [{label}]: the static MG has no line smoother")
    return launches


def timed_solve(fn):
    """(result, ms, K1 launches) of one synchronized call of fn() after one
    warm-up call, by the host clock; the launch counts are set to 0 between
    the two."""
    import torch

    from parelagmc_tpu_torch import kernels

    fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), kernels.launch_counts["thomas"]


def level_step(solver, sampler, level: int, key, batch: int, budget: int):
    """One MLMC step's solves at `level` on a fixed draw: the pair (levels
    above the coarsest) or the single cold solve; returns a closure giving
    (Q, [infos])."""
    xi = sampler.sample(level, key, batch)
    s_f = sampler.eval(level, xi)
    if level < len(solver.levels) - 1:
        s_c = sampler.eval(level + 1, xi, xi_level=level)

        def step():
            q, qc, info_f, info_c = solver.solve_fwd_pair(level, s_f, s_c, max_iters=budget)
            return q, [info_c, info_f]
    else:
        def step():
            q, _, info = solver.solve_fwd(level, s_f)
            return q, [info]
    return step


def phase_solvers_full(prob, device, gpu: str):
    """Phase 13b on the full SPE10 grid (phase 9's problem, production
    settings, one batch per level): the stacked against the sequential
    adjoint, and the gather against the structured coefMG on levels 1 and
    2, each at the production settings (Q to PRODUCTION_Q_RTOL) and at
    TIGHT_SETTINGS (Q to TIGHT_Q_RTOL).
    Returns {path: K1 launches of the timed solves}."""
    import dataclasses

    import numpy as np
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.coef_multigrid import build_coef_mg
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg, solver, sampler = prob.config, prob.solver, prob.sampler
    batches = list(cfg.batch_size_per_level)
    budget = MLMCManager(solver, sampler, cfg).pair_budget
    key = fold_in(PRNGKey(cfg.seed), 113)
    base_cfg = solver.solver_cfg
    launches = {"stacked": 0, "sequential": 0, "gather": 0}
    settings = (("production", {}, PRODUCTION_Q_RTOL),
                ("float32 state, rtol 1e-5", TIGHT_SETTINGS, TIGHT_Q_RTOL))
    for level, batch in enumerate(batches):
        step = level_step(solver, sampler, level, fold_in(key, level), batch, budget)
        for label, override, tol in settings:
            res = {}
            for mode, stacked in (("sequential", False), ("stacked", True)):
                # The solver reads its options at each solve; the cached
                # mean-field iterates serve both modes.
                solver.solver_cfg = dataclasses.replace(base_cfg, adjoint_stacked=stacked,
                                                        **override)
                (q, infos), ms, n_k1 = timed_solve(step)
                launches[mode] += n_k1
                res[mode] = (q.double(), infos, ms, n_k1)
            solver.solver_cfg = base_cfg
            (q_a, i_a, ms_a, k_a), (q_b, i_b, ms_b, k_b) = res["sequential"], res["stacked"]
            rel = ((q_b - q_a).abs() / q_a.abs()).max().item()
            conv = [float(torch.cat([i.converged.float() for i in infos]).mean())
                    for infos in (i_a, i_b)]
            print(f"SPE10 full grid level {level} batch {batch} adjoint sequential vs stacked "
                  f"[{label}]: max rel Q diff {rel:.3e} (tol {tol:g}) iterations (operator "
                  f"applications per member) {[i.iterations for i in i_a]} vs "
                  f"{[i.iterations for i in i_b]} converged {conv} step {ms_a:.1f} vs "
                  f"{ms_b:.1f} ms K1 launches {k_a} vs {k_b} [{gpu}]", flush=True)
            if not (torch.isfinite(q_b).all() and rel <= tol):
                fail(f"stacked adjoint level {level} [{label}]: Q differs from the sequential "
                     f"one by {rel}")
            if min(conv) < 1.0:
                fail(f"stacked adjoint level {level} [{label}]: converged fraction {conv}")
    if launches["stacked"] <= 0:
        fail("kernel thomas was not launched by the stacked adjoint steps")

    # Gather against structured coefMG, levels 1 and 2: the package's
    # build_coef_mg makes the gather tables of a level and they take the
    # structured ones' place for one cold solve. (Level 0's gathers would
    # hold batch x 3.4M faces x K values per apply - the reason the
    # structured form exists.) At the same two settings.
    ess_attr = np.asarray(cfg.ess_attr[:6], dtype=np.int64)
    for level in (1, 2):
        batch = batches[level]
        L = solver.levels[level]
        lvl = prob.hierarchy.levels[level]
        w = sampler.eval(level, sampler.sample(level, fold_in(key, 10 + level), batch))
        cold = lambda: solver.solve_fwd(level, w, max_iters=budget)
        struct_mg = L.coef_mg
        t0 = time.perf_counter()
        gather_mg = build_coef_mg(
            lvl.mesh, lvl.ess_faces(ess_attr), dtype=solver.dtype, device=device,
            cutoff=base_cfg.coarse_dense_cutoff, coarse_sweeps=max(1, base_cfg.mg_coarse_sweeps),
            omega=base_cfg.coefmg_omega, cheby_order=base_cfg.coefmg_cheby_order,
            cheby_lo=base_cfg.coefmg_cheby_lo)
        build_s = time.perf_counter() - t0
        for label, override, tol in settings:
            solver.solver_cfg = dataclasses.replace(base_cfg, **override)
            (q_s, _, info_s), ms_s, _ = timed_solve(cold)
            L.coef_mg = gather_mg
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            (q_g, _, info_g), ms_g, n_k1 = timed_solve(cold)
            launches["gather"] += n_k1
            peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
            del L.coef_mg  # a registered submodule: drop it before the tuple goes back
            L.coef_mg = struct_mg
            solver.solver_cfg = base_cfg
            rel = ((q_g - q_s).abs() / q_s.abs()).max().item()
            print(f"SPE10 full grid level {level} batch {batch} coefMG structured vs gather "
                  f"[{label}] ({len(struct_mg.levels)} MG levels, gather tables built in "
                  f"{build_s:.2f} s): max rel Q diff {rel:.3e} (tol {tol:g}) iterations "
                  f"{info_s.iterations} vs {info_g.iterations} cold solve {ms_s:.1f} vs "
                  f"{ms_g:.1f} ms, gather peak memory {peak_gb:.2f} GB [{gpu}]", flush=True)
            if not (torch.isfinite(q_g).all() and rel <= tol):
                fail(f"gather coefMG level {level} [{label}]: Q differs from the structured "
                     f"one by {rel}")
            if abs(info_s.iterations - info_g.iterations) > 2:
                fail(f"gather coefMG level {level} [{label}]: iterations {info_s.iterations} vs "
                     f"{info_g.iterations}")
            if not (bool(info_s.converged.all()) and bool(info_g.converged.all())):
                fail(f"gather coefMG level {level} [{label}]: not converged")
        del w, gather_mg
        torch.cuda.empty_cache()
    return launches


def phase_static_mg_full(device, gpu: str):
    """Phase 13b, the static Schur multigrid ("cg-schur" with the kinv_ref)
    on the full SPE10 grid, the preconditioner the per-sample coefMG
    replaced: one batch per level at the production tolerance and budget
    with the line smoother and the local scaling; iterations, converged
    fraction and ms are reported, only finite Q is required. Then K1 with
    R = batch on the level-1 grid's static line tables against its plain
    version. Returns (launches, K1 result dict)."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.ops.tridiag_pallas import thomas, thomas_plain
    from parelagmc_tpu_torch.physics.spe10 import full_grid_solver_defaults, load_spe10_kinv
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg = ProblemConfig(mesh="spe10", refinements=2, dtype="float32", correlation_length=100.0,
                        mse=-1.0, initial_samples=32, batch_size=32, normalize_marginals=True,
                        axis_order="auto", output_filename="")
    full_grid_solver_defaults(cfg)
    ds = cfg.darcy_solver
    ds.name = "cg-schur"
    ds.mg_line_smoother = True
    ds.local_schur_scaling = True
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prob = build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=(60, 220, 85)), device=device)
    setup_s = time.perf_counter() - t0
    solver, sampler = prob.solver, prob.sampler
    shapes = [[len(L.schur_mg.levels) + 1,
               0 if L.schur_mg.levels[0].line is None else len(L.schur_mg.levels[0].line)]
              for L in solver.levels]
    print(f"SPE10 full grid static Schur MG (cg-schur, kinv_ref, line smoother, local scaling): "
          f"host setup {setup_s:.2f} s, per level [MG levels, line smoothers on its finest] "
          f"{shapes} [{gpu}]", flush=True)
    budget = MLMCManager(solver, sampler, cfg).pair_budget
    key = fold_in(PRNGKey(cfg.seed), 213)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    for level, batch in enumerate(cfg.batch_size_per_level):
        w = sampler.eval(level, sampler.sample(level, fold_in(key, level), batch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, _, info = solver.solve_fwd(level, w, max_iters=budget)
        q = q.double().cpu()
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"SPE10 full grid static MG level {level} batch {batch}: cold solve {ms:.1f} ms "
              f"iterations (primal + adjoint, budget {budget} each) {info.iterations} converged "
              f"fraction {float(info.converged.float().mean()):.3f} max rel residual "
              f"{float(info.residual.max()):.3e} E[Q] {float(q.mean()):.4f} [{gpu}]", flush=True)
        if not torch.isfinite(q).all():
            fail(f"static MG level {level}: non-finite Q")
        del w
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"SPE10 full grid static MG: launches {launches} peak memory {peak_gb:.2f} GB [{gpu}]",
          flush=True)
    if launches["thomas"] <= 0:
        fail("kernel thomas was not launched by the static MG solves")

    # K1 with R = batch on the static line tables of the level-1 grid.
    level, batch = 1, cfg.batch_size_per_level[1]
    lines = solver.levels[level].schur_mg.levels[0].line
    if lines is None:
        fail("static MG: no line smoother on the SPE10 level-1 grid")
    g = torch.Generator(device=device).manual_seed(14)
    result = None
    for ln in lines:
        m, nlines = ln.d.shape
        b = torch.randn((batch, m, nlines), generator=g, device=device, dtype=ln.d.dtype)
        xk = thomas(ln.dl, ln.d, ln.du, b)
        xp = thomas_plain(ln.dl, ln.d, ln.du, b)
        torch.cuda.synchronize()
        abs_err = (xk - xp).abs().max().item()
        rel = abs_err / xp.abs().max().item()
        if not (torch.isfinite(xk).all() and rel <= F32_TOL_LINES):
            fail(f"K1 static MG lines (n {m}): rel err {rel} > {F32_TOL_LINES}")
        ms = cuda_ms(lambda: thomas(ln.dl, ln.d, ln.du, b))
        plain_ms = cuda_ms(lambda: thomas_plain(ln.dl, ln.d, ln.du, b), reps=3)
        bound = bytes_bound_ms(k1_rhs_bytes(ln.d.numel(), batch, b.element_size()))
        print(f"K1 thomas static MG line tables SPE10 level 1 {prob.hierarchy.levels[1].mesh.shape}"
              f" (n {m}, lines {nlines}) with R = batch = {batch} right-hand sides per table set "
              f"float32: max_rel_err {rel:.3e} (tol {F32_TOL_LINES:g}) kernel {ms:.4f} plain "
              f"{plain_ms:.4f} bound {bound:.4f} ms/line solve ({100 * bound / ms:.1f}% of bound) "
              f"[{gpu}]", flush=True)
        result = dict(R=batch, n=m, lines=nlines, rel=rel, abs_err=abs_err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bound)
    return launches, result


def phase_minres_box(device, gpu: str):
    """Phase 13b, minres-bj against cg-schur on the 64^3 box (MINRES_BOX:
    float64, a batch that fits the saddle system's gathers, a mild field):
    the same Q per sample, both converged."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem

    box = MINRES_BOX
    out, w = {}, None
    kernels.reset_launch_counts()
    for name in ("cg-schur", "minres-bj"):
        cfg = ProblemConfig(refinements=box["refinements"], batch_size=box["batch"],
                            dtype="float64", variance=box["variance"], output_filename="")
        cfg.darcy_solver.name = name
        cfg.darcy_solver.relative_tolerance = box["rtol"]
        cfg.darcy_solver.max_iterations = box["maxit"]
        cfg.darcy_solver.restart_every = 0
        cfg.darcy_solver.local_schur_scaling = True  # read by cg-schur alone
        prob = build_problem(cfg, device=device)
        if w is None:
            w = prob.sampler.eval(0, prob.sampler.sample(0, PRNGKey(64), box["batch"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        q, _, info = prob.solver.solve_fwd(0, w)
        q = q.cpu()
        out[name] = (q, info, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated(device) / 1e9)
        del prob
        torch.cuda.empty_cache()
    launches = dict(kernels.launch_counts)
    (q1, i1, t1, m1), (q2, i2, t2, m2) = out["cg-schur"], out["minres-bj"]
    rel = ((q2 - q1).abs() / q1.abs()).max().item()
    print(f"64^3 box (variance {box['variance']:g}, float64, batch {box['batch']}, "
          f"rtol {box['rtol']:g}, <= {box['maxit']} it) cg-schur vs minres-bj: "
          f"max rel Q diff {rel:.3e} (tol {MINRES_Q_RTOL:g}) iterations {i1.iterations} vs "
          f"{i2.iterations} converged {bool(i1.converged.all())} / {bool(i2.converged.all())} "
          f"solve {t1:.2f} vs {t2:.2f} s peak memory {m1:.2f} vs {m2:.2f} GB [{gpu}]", flush=True)
    if not (torch.isfinite(q2).all() and rel <= MINRES_Q_RTOL):
        fail(f"minres-bj on the 64^3 box: Q differs from cg-schur's by {rel}")
    if not (bool(i1.converged.all()) and bool(i2.converged.all())):
        fail("minres-bj / cg-schur on the 64^3 box: not converged")
    return launches


def rel_to_max(a, b) -> float:
    """max |a - b| / max |b| in float64 (0 when both are all zero)."""
    a, b = a.double(), b.double()
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale > 0 else diff


def phase_sharded_golden(device, gpu: str):
    """Phase 14: the golden MLMC under SampleMesh(SHARDS) in one process.
    Returns (the launches of the adaptive run, path_kernel_checks at one
    shard's batch)."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.parallel import SampleMesh
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg = ProblemConfig(refinements=2, batch_size=SHARD_BATCH)
    cfg.darcy_solver.relative_tolerance = 1e-5
    cfg.output_filename = ""
    prob = build_problem(cfg, device=device)
    sharded = MLMCManager(prob.solver, prob.sampler, cfg, sharding=SampleMesh(SHARDS))
    local = MLMCManager(prob.solver, prob.sampler, cfg, batch_size=SHARD_BATCH // SHARDS)
    if sharded.level_batch != [SHARD_BATCH] * 3:
        fail(f"sharded golden: level batches {sharded.level_batch}")
    for level in range(3):
        key = fold_in(PRNGKey(21), level)
        got = sharded._step(level)(key)
        parts = [local._step(level)(fold_in(key, i)) for i in range(SHARDS)]
        want = [torch.cat(p) for p in zip(*parts)]
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(rel_to_max(a, b) for a, b in zip(got[:2], want[:2]))
        agree = "bit for bit" if equal else f"max diff {err:.3e} of max |q| (tol {SHARD_RTOL:g})"
        print(f"sharded golden level {level}: SampleMesh({SHARDS}) step at batch {SHARD_BATCH} "
              f"against {SHARDS} unsharded steps at batch {SHARD_BATCH // SHARDS} keyed "
              f"fold_in(key, i): q, qc and iterations agree {agree}; mean iterations "
              f"{float(got[2].mean()):.1f} [{gpu}]", flush=True)
        if got[0].shape != (SHARD_BATCH,) or not torch.isfinite(got[0]).all():
            fail(f"sharded golden level {level}: q of shape {tuple(got[0].shape)} or not finite")
        if not equal and not (err <= SHARD_RTOL and torch.equal(got[2], want[2])):
            fail(f"sharded golden level {level}: the shards differ from the unsharded steps "
                 f"({err})")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est = sharded.run()
    dt = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    cons = [float(c) for c in sharded.consistency[:-1]]
    print(f"sharded golden MLMC run ({SHARDS} shards in one process): estimate {est:.6f} "
          f"consistency {cons} samples {sharded.level_nsamples.tolist()} run {dt:.2f} s "
          f"launches K1 {launches['thomas']} K2 {launches['threefry_normal']}; "
          f"torch.cuda.device_count() {torch.cuda.device_count()}: the torch.distributed "
          f"execution (a shard per rank, all_gather) ran only in the CPU test "
          f"(tests/test_torch_sharding.py, two gloo processes), not here [{gpu}]", flush=True)
    if not math.isfinite(est) or abs(est - 2.56) >= 0.25:
        fail(f"sharded golden estimate {est} not within 0.25 of 2.56")
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the sharded golden MLMC run")
    shard = SHARD_BATCH // SHARDS
    checks = path_kernel_checks(prob, [shard] * 3, PRNGKey(22), F32_TOL_K1, F32_TOL_K2,
                                f"sharded golden, one shard (batch {shard})", gpu)
    return launches, checks


def tet_cube(refine: int):
    """The GeneralMesh of the unit cube cut into six tets (TET_SPLIT), box
    sides labelled (label_box_boundaries_gm), refined `refine` times."""
    import numpy as np

    from parelagmc_tpu_torch.fem.simplicial_hierarchy import refine_simplicial
    from parelagmc_tpu_torch.mesh.mfem_io import GeneralMesh
    from parelagmc_tpu_torch.unstructured import label_box_boundaries_gm

    verts = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1),
                      (0, 1, 1)], dtype=np.float64)
    tets = np.array(TET_SPLIT, dtype=np.int64)
    faces = np.concatenate([np.delete(tets, i, axis=1) for i in range(4)])
    uniq, counts = np.unique(np.sort(faces, axis=1), axis=0, return_counts=True)
    boundary = uniq[counts == 1]
    gm = GeneralMesh(dim=3, vertices=verts, elements=list(tets),
                     attributes=np.ones(len(tets), dtype=np.int32),
                     geom_types=np.full(len(tets), 4, dtype=np.int32), boundary=list(boundary),
                     boundary_attributes=np.ones(len(boundary), dtype=np.int32))
    if not label_box_boundaries_gm(gm):
        fail("tet cube: a boundary face off the box")
    for _ in range(refine):
        gm, _ = refine_simplicial(gm)
    return gm


def unstructured_config(levels: int, batch: int):
    from parelagmc_tpu_torch.problems import ProblemConfig

    u = UNSTRUCTURED
    cfg = ProblemConfig(refinements=levels - 1, correlation_length=u["corlen"],
                        variance=u["variance"], batch_size=batch, dtype="float32",
                        output_filename="", cost_model="dofs")
    cfg.darcy_solver.name = u["solver"]
    cfg.darcy_solver.relative_tolerance = u["rtol"]
    cfg.darcy_solver.max_iterations = u["maxit"]
    return cfg


def unstructured_step(sampler, solver, level: int, batch: int):
    """key -> (Q - Qc, converged per sample, iterations of the fine and
    the coarse solve) of one MLMC batch at `level`: the coupled pair through
    eval_pair and solve_fwd_pair, one solve on the coarsest level."""
    import torch

    def step(key):
        xi = sampler.sample(level, key, batch)
        if level < solver.hierarchy.nlevels - 1:
            s_f, s_c = sampler.eval_pair(level, xi)
            q, qc, i_f, i_c = solver.solve_fwd_pair(level, s_f, s_c)
            return q - qc, i_f.converged & i_c.converged, (i_f.iterations, i_c.iterations)
        q, _, info = solver.solve_fwd(level, sampler.eval(level, xi))
        return q, info.converged, (info.iterations,)

    def synced(key):
        out = step(key)
        torch.cuda.synchronize()
        return out

    return synced


def time_steps(step, key, reps: int):
    """(samples/s over `reps` steps after one warm-up step, mean
    iterations of each solve of a step, converged fraction, the last
    step's Y)."""
    from parelagmc_tpu_torch.ops.prng import fold_in

    step(fold_in(key, 999))
    t0 = time.perf_counter()
    outs = [step(fold_in(key, i)) for i in range(reps)]
    dt = time.perf_counter() - t0
    n = sum(o[0].numel() for o in outs)
    conv = sum(float(o[1].float().sum()) for o in outs) / n
    iters = "/".join(f"{sum(o[2][i] for o in outs) / reps:.1f}" for i in range(len(outs[0][2])))
    return n / dt, iters, conv, outs[-1][0]


def timed_call(fn, *args):
    """(fn(*args), seconds it took)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def scipy_oracle_q(level, solver, w) -> float:
    """Q of the level's saddle system [[M(w), B^T], [B, 0]] (essential
    faces eliminated as the device operator does) by a float64 direct solve
    on the host."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    L = solver._lv[0]
    ess = L["ess"].cpu().numpy()
    keep = sp.diags((~ess).astype(np.float64))
    B = (level.b_csr() @ keep).tocsr()
    M = keep @ level.mass_csr(w) @ keep + sp.diags(ess.astype(np.float64))
    A = sp.bmat([[M, B.T], [B, None]], format="csc")
    x = spla.spsolve(A, L["rhs"].double().cpu().numpy())
    return float(x @ L["obs"].double().cpu().numpy())


def phase_unstructured_agglomerated(device, gpu: str):
    """Phase 15. Returns (launches of the MLMC run, K2's result at the
    level-0 draw, the context phase 17 reuses: hierarchy, sampler, solver,
    the oracle's field and Q, the per-level step numbers)."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.fem.agglomeration import build_agglomerated_hierarchy
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver, UnstructuredSPDESampler

    u = UNSTRUCTURED
    t0 = time.perf_counter()
    gm = tet_cube(u["refine"])
    hier = build_agglomerated_hierarchy(gm, u["levels"], coarsening_factor=u["coarsening_factor"])
    hier_s = time.perf_counter() - t0
    cells = [int(l.n_s) for l in hier.levels]
    faces = [int(l.n_u) for l in hier.levels]
    cfg = unstructured_config(u["levels"], u["batch"])
    t0 = time.perf_counter()
    solver = UnstructuredDarcySolver(hier, cfg, torch.float32, device=device)
    sampler = UnstructuredSPDESampler(hier, cfg, torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    dofs = [solver.num_dofs(l) for l in range(u["levels"])]
    print(f"unstructured agglomerated: cube of 6 tets refined {u['refine']} times, "
          f"{u['levels']} levels, coarsening factor {u['coarsening_factor']}: cells {cells} "
          f"faces {faces} Darcy dofs {dofs}; host setup: mesh + hierarchy {hier_s:.2f} s, "
          f"solver + sampler {setup_s:.2f} s [{gpu}]", flush=True)
    if (cells[0], faces[0]) != UNSTRUCTURED_FINE or len(cells) != u["levels"]:
        fail(f"unstructured agglomerated: cells {cells} faces {faces}")

    # The oracle's direct solve (about a minute of one host core) runs in a
    # thread beside the device work below; scipy releases the interpreter
    # lock while it factors.
    key = PRNGKey(31)
    w = sampler.eval(0, sampler.sample(0, fold_in(key, 77), 1))
    q_dev, _, oracle_info = solver.solve_fwd(0, w)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    oracle = pool.submit(timed_call, scipy_oracle_q, hier.levels[0], solver,
                         w[0].double().cpu().numpy())
    pool.shutdown(wait=False)
    steps = []
    for level in range(u["levels"]):
        step = unstructured_step(sampler, solver, level, u["batch"])
        sps, iters, conv, y = time_steps(step, fold_in(key, level), reps=2)
        steps.append((sps, iters, conv))
        kind = "pair (eval_pair + solve_fwd_pair)" if level < u["levels"] - 1 else "single solve"
        print(f"unstructured agglomerated level {level} {kind}, batch {u['batch']}, f32, "
              f"{u['solver']} rtol {u['rtol']:g}: {sps:.1f} samples/s, mean iterations "
              f"(fine/coarse) {iters}, converged fraction {conv:.4f} (least "
              f"{UNSTRUCTURED_MIN_CONVERGED}) [{gpu}]", flush=True)
        if conv < UNSTRUCTURED_MIN_CONVERGED or not torch.isfinite(y).all():
            fail(f"unstructured agglomerated level {level}: converged {conv}, or Y not finite")

    mgr = MLMCManager(solver, sampler, cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mgr.init_run([UNSTRUCTURED_SAMPLES] * u["levels"])
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    print(mgr.show_me(), flush=True)
    cons = [float(c) for c in mgr.consistency[:-1]]
    est = float(mgr.estimate)
    print(f"unstructured agglomerated MLMC init_run({[UNSTRUCTURED_SAMPLES] * u['levels']}): "
          f"estimate {est:.6f} consistency {cons} E[Q] {mgr.eQ.tolist()} mean iterations "
          f"{mgr.solver_iterations.tolist()} run {run_s:.2f} s launches {launches} [{gpu}]",
          flush=True)
    if not math.isfinite(est) or not all(c < 0.1 for c in cons):
        fail(f"unstructured agglomerated MLMC: estimate {est}, consistency {cons}")
    if launches["threefry_normal"] <= 0:
        fail("kernel threefry_normal was not launched by the unstructured MLMC run")

    q_host, host_s = oracle.result()
    rel = abs(float(q_dev[0]) - q_host) / abs(q_host)
    print(f"unstructured agglomerated oracle, level 0, one sample: device f32 Q {float(q_dev[0]):.7g} "
          f"({oracle_info.iterations} iterations) against scipy spsolve f64 {q_host:.7g}: rel err "
          f"{rel:.2e} (tol {UNSTRUCTURED_ORACLE_RTOL:g}; spsolve {host_s:.1f} s in a thread beside "
          f"the steps above) [{gpu}]", flush=True)
    if not rel <= UNSTRUCTURED_ORACLE_RTOL:
        fail(f"unstructured oracle: device Q off the direct solve's by {rel}")

    shape = (u["batch"], cells[0])
    _, k2 = k2_check(fold_in(key, 5), shape, torch.float32, device, F32_TOL_K2,
                     f"unstructured {shape}")
    print(k2_line(f"unstructured agglomerated level 0: K2 noise {shape} float32", k2, F32_TOL_K2,
                  gpu), flush=True)
    ctx = dict(hier=hier, sampler=sampler, solver=solver, oracle_w=w, oracle_q=q_host,
               steps=steps)
    return launches, dict(k2, max_abs_err=k2["abs_err"], shape=list(shape)), ctx


def kernel_split(fn, top: int = 4) -> str:
    """The `top` CUDA kernels of one call of fn by device time (profiler,
    CUDA activity alone): name (cut to 60 characters), share of the
    kernels' total, calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kern)
    if total <= 0:
        return "not measured (the profiler recorded no device event)"
    kern.sort(key=lambda e: -e.self_device_time_total)
    return "; ".join(f"{e.key[:60]} {100 * e.self_device_time_total / total:.1f}% ({e.count})"
                     for e in kern[:top])


def device_busy(fn, wall_ms: float):
    """(busy share, device ms, kernels) of one call of fn: the kernels'
    device time recorded by torch.profiler (CUDA activity alone, so that a
    call of ~10^5 kernels stays cheap to trace; a lower bound if the
    profiler drops events) over `wall_ms`, the synchronized host wall of an
    unprofiled call. (None, None, None) if no device event was recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device = sum(e.self_device_time_total for e in kern) / 1e3
    if device <= 0.0:
        return None, None, None
    return device / wall_ms, device, sum(e.count for e in kern)


def phase_unstructured_nested(device, gpu: str):
    """Phase 16. Returns (launches of one pair step, K2's result at its
    draw, the context phase 18 reuses: hierarchy, sampler and this step's
    numbers)."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver, UnstructuredSPDESampler

    n = NESTED
    t0 = time.perf_counter()
    hier = build_simplicial_hierarchy(tet_cube(n["refine"]), n["levels"])
    hier_s = time.perf_counter() - t0
    cells = [int(l.n_s) for l in hier.levels]
    if cells != n["cells"]:
        fail(f"unstructured nested: cells {cells}")
    cfg = unstructured_config(n["levels"], n["batch"])
    t0 = time.perf_counter()
    solver = UnstructuredDarcySolver(hier, cfg, torch.float32, device=device)
    sampler = UnstructuredSPDESampler(hier, cfg, torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    step = unstructured_step(sampler, solver, 0, n["batch"])
    key = PRNGKey(41)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    step(key)  # also the warm-up of the timed step
    launches = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    y, converged, iters = step(fold_in(key, 1))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    conv = float(converged.float().mean())
    share, device_ms, nkern = device_busy(lambda: step(fold_in(key, 1)), wall_ms)
    busy = "not measured (the profiler recorded no device event)" if share is None else (
        f"{100 * share:.1f}% ({device_ms:.1f} device ms in {wall_ms:.1f} wall ms, {nkern} "
        f"kernels)")
    print(f"unstructured nested level-0 pair step: cells {cells}, Darcy dofs "
          f"{[solver.num_dofs(l) for l in range(n['levels'])]}, batch {n['batch']}, f32, "
          f"{UNSTRUCTURED['solver']} rtol {UNSTRUCTURED['rtol']:g}; host setup: mesh + hierarchy "
          f"{hier_s:.2f} s, solver + sampler {setup_s:.2f} s; {1e3 * n['batch'] / wall_ms:.2f} "
          f"samples/s, iterations (fine/coarse) {iters[0]}/{iters[1]}, converged fraction "
          f"{conv:.4f}, device busy {busy}, peak memory {peak:.2f} GB, launches of one step "
          f"{launches} [{gpu}]", flush=True)
    if conv < 1.0 or not torch.isfinite(y).all():
        fail(f"unstructured nested pair step: converged {conv}, or Y not finite")
    if launches["threefry_normal"] <= 0:
        fail("kernel threefry_normal was not launched by the nested unstructured pair step")
    shape = (n["batch"], cells[0])
    _, k2 = k2_check(fold_in(key, 5), shape, torch.float32, device, F32_TOL_K2,
                     f"unstructured {shape}")
    print(k2_line(f"unstructured nested level 0: K2 noise {shape} float32", k2, F32_TOL_K2, gpu),
          flush=True)
    ctx = dict(hier=hier, sampler=sampler, sps=1e3 * n["batch"] / wall_ms, iters=iters,
               busy=busy, peak=peak)
    return launches, dict(k2, max_abs_err=k2["abs_err"], shape=list(shape)), ctx


def hybrid_kinds(solver) -> list:
    """Per level of an UnstructuredDarcySolver: "geometric" (simplicial
    element geometry), "algebraic" (agglomerated level) or "minres" (both
    hybrid table constructions declined)."""
    return ["minres" if h is None else
            ("geometric" if hasattr(solver.hierarchy.levels[l], "mesh") else "algebraic")
            for l, h in enumerate(solver._hybrid)]


def pair_fields(sampler, level: int, key, batch: int):
    """The fields of one MLMC batch at `level`: (fine, coarse) of
    eval_pair, or (field, None) on the coarsest level."""
    xi = sampler.sample(level, key, batch)
    if level < sampler.hierarchy.nlevels - 1:
        return sampler.eval_pair(level, xi)
    return sampler.eval(level, xi), None


def solve_batch(solver, level: int, fields):
    """(q, qc or None, converged per sample, iterations fine/coarse) of one
    batch's solves: the pair, or one solve on the coarsest level."""
    s_f, s_c = fields
    if s_c is None:
        q, _, info = solver.solve_fwd(level, s_f)
        return q, None, info.converged, (info.iterations,)
    q, qc, i_f, i_c = solver.solve_fwd_pair(level, s_f, s_c)
    return q, qc, i_f.converged & i_c.converged, (i_f.iterations, i_c.iterations)


def phase_hybrid_agglomerated(ctx, device, gpu: str):
    """Phase 17 (A): phase 15's hierarchy and sampler under hybrid-cg.
    Returns launches of its MLMC run."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver

    u = UNSTRUCTURED
    hier, sampler, minres_solver = ctx["hier"], ctx["sampler"], ctx["solver"]
    cfg = unstructured_config(u["levels"], u["batch"])
    cfg.darcy_solver.name = "hybrid-cg"
    t0 = time.perf_counter()
    solver = UnstructuredDarcySolver(hier, cfg, torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    kinds = hybrid_kinds(solver)
    print(f"hybrid-cg agglomerated: levels hybridized {kinds}, solver setup (coefMG + hybrid "
          f"tables) {setup_s:.2f} s [{gpu}]", flush=True)
    if kinds != HYBRID_AGGLOMERATED_KINDS:
        fail(f"hybrid-cg agglomerated: levels {kinds}, expected {HYBRID_AGGLOMERATED_KINDS}")
    # Reference Q of the comparison fields: hybrid-cg in float64, deep
    # (HYBRID_TRUTH) and at the run's rtol (the error the tolerance leaves).
    refs = {}
    for name, rtol in (("truth", HYBRID_TRUTH["rtol"]), ("f64", u["rtol"])):
        c = unstructured_config(u["levels"], u["batch"])
        c.darcy_solver.name, c.dtype = "hybrid-cg", "float64"
        c.darcy_solver.relative_tolerance = rtol
        c.darcy_solver.max_iterations = HYBRID_TRUTH["maxit"]
        refs[name] = UnstructuredDarcySolver(hier, c, torch.float64, device=device)

    def err(a, b):
        """(max, median) over samples of |a - b| / max |b|."""
        e = (a.double() - b.double()).abs() / b.double().abs().max()
        return float(e.max()), float(e.median())

    key = PRNGKey(37)
    for level in range(u["levels"]):
        torch.cuda.reset_peak_memory_stats(device)
        step = unstructured_step(sampler, solver, level, u["batch"])
        sps, iters, conv, y = time_steps(step, fold_in(key, level), reps=2)
        wall_ms = 1e3 * u["batch"] / sps
        share, device_ms, nkern = device_busy(lambda: step(fold_in(key, 100 + level)), wall_ms)
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        busy = "not measured" if share is None else (
            f"{100 * share:.1f}% ({device_ms:.1f} device ms against {wall_ms:.1f} wall ms a "
            f"step, {nkern} kernels)")
        # The same fields through minres-coefmg (phase 15's solver) and the
        # float64 references: Q and Qc per sample.
        fields = pair_fields(sampler, level, fold_in(key, 200 + level), u["batch"])
        q_h, qc_h, ok_h, _ = solve_batch(solver, level, fields)
        q_m, qc_m, ok_m, _ = solve_batch(minres_solver, level, fields)
        f64 = tuple(None if f is None else f.double() for f in fields)
        ref = {name: solve_batch(r, level, f64) for name, r in refs.items()}
        both = ok_h & ok_m
        pairs = [(q_h, q_m, ref["truth"][0], ref["f64"][0])]
        if qc_h is not None:
            pairs.append((qc_h, qc_m, ref["truth"][1], ref["f64"][1]))
        vs_minres = [err(a[both], b[both]) for a, b, _, _ in pairs]
        vs_truth = [err(a, t) for a, _, t, _ in pairs]
        f64_truth = [err(f, t) for _, _, t, f in pairs]
        minres_truth = [err(b[ok_m], t[ok_m]) for _, b, t, _ in pairs]
        m_sps, m_iters, m_conv = ctx["steps"][level]
        fmt = lambda errs: "[" + ", ".join(f"{a:.2e}/{b:.2e}" for a, b in errs) + "]"
        print(f"hybrid-cg agglomerated level {level} ({kinds[level]}), batch {u['batch']}, f32, "
              f"rtol {u['rtol']:g}: {sps:.1f} samples/s, mean iterations (fine/coarse) {iters}, "
              f"converged fraction {conv:.4f}, device busy {busy}, peak memory {peak:.2f} GB; "
              f"minres-coefmg (phase 15) {m_sps:.1f} samples/s, iterations {m_iters}, converged "
              f"{m_conv:.4f}. Q (and Qc) per sample, max/median of |diff| / max |Q|: "
              f"hybrid-cg against minres-coefmg over the {int(both.sum())} samples both "
              f"converged {fmt(vs_minres)}; against a float64 hybrid-cg solve at rtol "
              f"{HYBRID_TRUTH['rtol']:g}: hybrid-cg {fmt(vs_truth)}, float64 hybrid-cg at rtol "
              f"{u['rtol']:g} {fmt(f64_truth)}, minres-coefmg (converged) {fmt(minres_truth)} "
              f"(limits {HYBRID_Q_RTOL['max']:g}/{HYBRID_Q_RTOL['median']:g}) [{gpu}]",
              flush=True)
        if conv < 1.0 or not bool(ok_h.all()) or not torch.isfinite(y).all():
            fail(f"hybrid-cg agglomerated level {level}: converged {conv}, or Y not finite")
        for mx, med in vs_minres + vs_truth:
            if not (mx <= HYBRID_Q_RTOL["max"] and med <= HYBRID_Q_RTOL["median"]):
                fail(f"hybrid-cg agglomerated level {level}: Q against minres-coefmg "
                     f"{vs_minres}, against float64 {vs_truth}")

    q_dev, _, info = solver.solve_fwd(0, ctx["oracle_w"])
    rel = abs(float(q_dev[0]) - ctx["oracle_q"]) / abs(ctx["oracle_q"])
    print(f"hybrid-cg agglomerated oracle, level 0, phase 15's sample: device f32 Q "
          f"{float(q_dev[0]):.7g} ({info.iterations} iterations) against its scipy spsolve f64 "
          f"{ctx['oracle_q']:.7g}: rel err {rel:.2e} (tol {UNSTRUCTURED_ORACLE_RTOL:g}) [{gpu}]",
          flush=True)
    if not rel <= UNSTRUCTURED_ORACLE_RTOL:
        fail(f"hybrid-cg oracle: device Q off the direct solve's by {rel}")

    mgr = MLMCManager(solver, sampler, cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mgr.init_run([UNSTRUCTURED_SAMPLES] * u["levels"])
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    cons = [float(c) for c in mgr.consistency[:-1]]
    est = float(mgr.estimate)
    print(f"hybrid-cg agglomerated MLMC init_run({[UNSTRUCTURED_SAMPLES] * u['levels']}): "
          f"estimate {est:.6f} consistency {cons} E[Q] {mgr.eQ.tolist()} mean iterations "
          f"{mgr.solver_iterations.tolist()} run {run_s:.2f} s launches {launches} [{gpu}]",
          flush=True)
    if not math.isfinite(est) or not all(c < 0.1 for c in cons):
        fail(f"hybrid-cg agglomerated MLMC: estimate {est}, consistency {cons}")
    if launches["threefry_normal"] <= 0:
        fail("kernel threefry_normal was not launched by the hybrid-cg MLMC run")
    return launches


def phase_hybrid_nested(ctx, device, gpu: str):
    """Phase 18 (B): phase 16's nested level-0 pair step under hybrid-cg.
    Returns launches of one step."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver

    n = NESTED
    hier, sampler = ctx["hier"], ctx["sampler"]
    cfg = unstructured_config(n["levels"], n["batch"])
    cfg.darcy_solver.name = "hybrid-cg"
    t0 = time.perf_counter()
    solver = UnstructuredDarcySolver(hier, cfg, torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    kinds = hybrid_kinds(solver)
    step = unstructured_step(sampler, solver, 0, n["batch"])
    key = PRNGKey(41)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    step(key)  # also the warm-up of the timed step
    launches = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    y, converged, iters = step(fold_in(key, 1))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    conv = float(converged.float().mean())
    share, device_ms, nkern = device_busy(lambda: step(fold_in(key, 1)), wall_ms)
    busy = "not measured (the profiler recorded no device event)" if share is None else (
        f"{100 * share:.1f}% ({device_ms:.1f} device ms in {wall_ms:.1f} wall ms, {nkern} "
        f"kernels)")
    # The Darcy pair alone, on the step's fields: kernels and device ms per
    # PCG iteration.
    s_f, s_c = pair_fields(sampler, 0, fold_in(key, 1), n["batch"])
    t0 = time.perf_counter()
    _, _, i_f, i_c = solver.solve_fwd_pair(0, s_f, s_c)
    torch.cuda.synchronize()
    solve_ms = 1e3 * (time.perf_counter() - t0)
    _, s_dev, s_kern = device_busy(lambda: solver.solve_fwd_pair(0, s_f, s_c), solve_ms)
    its = i_f.iterations + i_c.iterations
    per_it = "not measured" if s_dev is None else (
        f"{s_kern / its:.0f} kernels and {s_dev / its:.2f} device ms per PCG iteration "
        f"({its} iterations, {solve_ms:.1f} wall ms); its kernels by device time: "
        f"{kernel_split(lambda: solver.solve_fwd_pair(0, s_f, s_c))}")
    print(f"hybrid-cg nested level-0 pair step: levels {kinds}, setup {setup_s:.2f} s, batch "
          f"{n['batch']}, f32, rtol {UNSTRUCTURED['rtol']:g}: {1e3 * n['batch'] / wall_ms:.2f} "
          f"samples/s, iterations (fine/coarse) {iters[0]}/{iters[1]}, converged fraction "
          f"{conv:.4f}, device busy {busy}; Darcy pair {per_it}; peak memory {peak:.2f} GB, "
          f"launches of one step {launches}; minres-coefmg (phase 16): {ctx['sps']:.2f} "
          f"samples/s, iterations {ctx['iters'][0]}/{ctx['iters'][1]}, busy {ctx['busy']}, peak "
          f"{ctx['peak']:.2f} GB [{gpu}]", flush=True)
    if kinds != ["geometric"] * n["levels"]:
        fail(f"hybrid-cg nested: levels {kinds}")
    if conv < 1.0 or not torch.isfinite(y).all():
        fail(f"hybrid-cg nested pair step: converged {conv}, or Y not finite")
    if launches["threefry_normal"] <= 0:
        fail("kernel threefry_normal was not launched by the hybrid-cg nested pair step")
    return launches


def tet_box(ncells: int, origin: float, length: float):
    """(vertices, tets, boundary triangles) of the cube [origin, origin +
    length]^3 cut into ncells^3 hexes, each in six tets (TET_SPLIT)."""
    import numpy as np

    axis = origin + length * np.arange(ncells + 1) / ncells
    grids = np.meshgrid(axis, axis, axis, indexing="ij")
    verts = np.stack([g.ravel(order="F") for g in grids], axis=1)
    m = ncells + 1
    vid = lambda i, j, k: i + m * (j + m * k)
    tets = []
    for k in range(ncells):
        for j in range(ncells):
            for i in range(ncells):
                c = [vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
                     vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1),
                     vid(i, j + 1, k + 1)]
                tets.extend([[c[v] for v in t] for t in TET_SPLIT])
    tets = np.asarray(tets, dtype=np.int64)
    faces = np.concatenate([np.delete(tets, i, axis=1) for i in range(4)])
    uniq, counts = np.unique(np.sort(faces, axis=1), axis=0, return_counts=True)
    return verts, tets, uniq[counts == 1]


def write_tet_mesh(path: str, verts, tets, boundary, attributes=None, battributes=None) -> None:
    """Tets and their boundary triangles as an MFEM v1.0 mesh file."""
    import numpy as np

    attributes = np.ones(len(tets), int) if attributes is None else attributes
    battributes = np.ones(len(boundary), int) if battributes is None else battributes
    lines = ["MFEM mesh v1.0", "", "dimension", "3", "", "elements", str(len(tets))]
    lines += [f"{a} 4 {t[0]} {t[1]} {t[2]} {t[3]}" for a, t in zip(attributes, tets)]
    lines += ["", "boundary", str(len(boundary))]
    lines += [f"{a} 2 {b[0]} {b[1]} {b[2]}" for a, b in zip(battributes, boundary)]
    lines += ["", "vertices", str(len(verts)), "3"]
    lines += [" ".join(repr(float(x)) for x in v) for v in verts]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def timed_into(acc: list, fn):
    """fn, adding the seconds of each call to acc[0]."""
    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[0] += time.perf_counter() - t0
    return timed


def phase_mesh_files(device, gpu: str):
    """Phase 19 (C): the mesh-file path through build_problem. Returns
    ({config: launches of its MLMC round}, [K2 results at the embedded
    draws])."""
    import tempfile

    import numpy as np
    import torch

    from parelagmc_tpu_torch import kernels, native, unstructured
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.problems import build_problem
    from parelagmc_tpu_torch.uq import MLMCManager
    from parelagmc_tpu_torch.unstructured import UnstructuredProjectionSPDESampler

    mf = MESH_FILES
    t0 = time.perf_counter()
    native.build_library()
    native_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="mesh_files_")
    try:
        coarse = os.path.join(tmp, "cube.mesh")
        box = tet_box(*mf["coarse"])
        write_tet_mesh(coarse, *box)
        v, t, b = tet_box(*mf["embed"])
        c = v[t].mean(axis=1)
        inside = np.all((c > 0.0) & (c < 1.0), axis=1)
        write_tet_mesh(os.path.join(tmp, "cube_embed.mesh"), v, t, b, np.where(inside, 1, 2))
        enlarge = tet_box(*mf["enlarge"])
        write_tet_mesh(os.path.join(tmp, "cube_enlarge.mesh"), *enlarge)
        print(f"mesh files: native geometry library {os.path.relpath(native.library_path(), HERE)} "
              f"ready in {native_s:.2f} s (g++ at first use); files in a temporary directory: "
              f"coarsest {len(box[1])} tets, matching embedding {len(t)} tets "
              f"({int(inside.sum())} of material 1), non-matching enlargement "
              f"{len(enlarge[1])} tets [{gpu}]", flush=True)
        launches, k2s, probs = {}, [], {}
        for name, kw in MESH_FILE_CASES:
            cfg = unstructured_config(mf["levels"], mf["batch"])
            cfg.darcy_solver.name = "hybrid-cg"
            cfg.mesh = coarse
            for k, val in kw.items():
                setattr(cfg, k, val)
            if name == "agglomerated":
                # The file is the finest mesh: the plain case's level 0.
                gm = probs["plain"].hierarchy.levels[0].mesh
                cfg.mesh = os.path.join(tmp, "cube_fine.mesh")
                write_tet_mesh(cfg.mesh, gm.vertices, np.stack(gm.elements),
                               np.stack(gm.boundary), gm.attributes, gm.boundary_attributes)
            # The mortar couplings' share of the setup: the projection
            # sampler's two assemblers, timed where the sampler calls them.
            mortar_s = [0.0]
            saved = {f: getattr(unstructured, f) for f in MORTAR_ASSEMBLERS}
            for f, fn in saved.items():
                setattr(unstructured, f, timed_into(mortar_s, fn))
            try:
                t0 = time.perf_counter()
                prob = build_problem(cfg, device=device)
                setup_s = time.perf_counter() - t0
            finally:
                for f, fn in saved.items():
                    setattr(unstructured, f, fn)
            probs[name] = prob
            cells = [int(l.n_s) for l in prob.hierarchy.levels]
            embed = ([] if prob.embed_hierarchy is None else
                     [int(l.n_s) for l in prob.embed_hierarchy.levels])
            kinds = hybrid_kinds(prob.solver)
            mgr = MLMCManager(prob.solver, prob.sampler, prob.config)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            mgr.init_run([mf["batch"]] * mf["levels"])
            run_s = time.perf_counter() - t0
            launches[name] = dict(kernels.launch_counts)
            est = float(mgr.estimate)
            print(f"mesh file [{name}] {type(prob.sampler).__name__}: cells {cells} embedded "
                  f"{embed}, levels {kinds}; host setup (build_problem) {setup_s:.2f} s, of it "
                  f"mortar assembly {mortar_s[0]:.2f} s; "
                  f"one MLMC batch of {mf['batch']} a level: estimate {est:.6f} E[Q] "
                  f"{mgr.eQ.tolist()} mean iterations {mgr.solver_iterations.tolist()} run "
                  f"{run_s:.2f} s launches {launches[name]} [{gpu}]", flush=True)
            if not math.isfinite(est) or not np.isfinite(mgr.eQ).all():
                fail(f"mesh file [{name}]: estimate {est}")
            if kinds[0] != "geometric" or "minres" in kinds:
                fail(f"mesh file [{name}]: levels {kinds}")
            if launches[name]["threefry_normal"] <= 0:
                fail(f"kernel threefry_normal was not launched by the mesh-file run [{name}]")
            if embed:
                shape = (mf["batch"], embed[0])
                _, k2 = k2_check(fold_in(PRNGKey(43), embed[0]), shape, torch.float32, device,
                                 F32_TOL_K2, f"embedded {shape}")
                print(k2_line(f"mesh file [{name}] level 0: K2 noise {shape} float32", k2,
                              F32_TOL_K2, gpu), flush=True)
                k2s.append(dict(k2, max_abs_err=k2["abs_err"], shape=list(shape)))
            mgr.close()
        # On the matching embedding, the P0 projection is the selection.
        match = probs["matching"]
        proj = UnstructuredProjectionSPDESampler(match.hierarchy, match.embed_hierarchy,
                                                 match.config, torch.float32, device=device)
        xi = match.sampler.sample(0, PRNGKey(47), mf["batch"])
        rel = rel_to_max(proj.eval(0, xi), match.sampler.eval(0, xi))
        print(f"mesh file: projection (order 0) on the matching embedding against the matching "
              f"sampler, level 0, batch {mf['batch']}: max rel {rel:.2e} (tol "
              f"{EMBED_AGREE_TOL:g}) [{gpu}]", flush=True)
        if not rel <= EMBED_AGREE_TOL:
            fail(f"mesh file: matching and projection samplers differ by {rel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, k2s


def jax_modules_loaded():
    """Names in sys.modules of jax or of the JAX package (parelagmc_tpu)."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "parelagmc_tpu") or m.startswith(("jax.", "parelagmc_tpu.")))


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
    if jax_modules_loaded():
        fail(f"imported {jax_modules_loaded()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    gpu = gpu_info()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = kernels.build_library()
    kernels.library()
    print(f"build: {[os.path.relpath(p, HERE) for p in libs]} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'}); "
          f"SM clocks {sm_clocks_per_s() / 1e12:.3f} T/s [{gpu}]", flush=True)

    phase_k1(device, gpu)
    phase_k2(device, gpu)
    k3, k3_launches = phase_k3(device, gpu)
    golden = phase_mlmc(device, gpu)
    sharded, sharded_checks = phase_sharded_golden(device, gpu)
    phase_bench(device, gpu)
    phase_64(device, gpu)
    anchor, _ = phase_spe10_anchor(device, gpu)
    samplers = phase_samplers(device, gpu)
    ratio_anchor = phase_ratio_anchor(device, gpu)
    t0 = time.perf_counter()
    spe10 = spe10_full_problem(device)
    setup_s = time.perf_counter() - t0
    phase_k1_lines(spe10, device, gpu)
    full, checks = phase_spe10_full(spe10, setup_s, device, gpu)
    ratio_full = phase_ratio_full(spe10, device, gpu)
    full_solvers = phase_solvers_full(spe10, device, gpu)
    del spe10
    static_full, k1_static = phase_static_mg_full(device, gpu)
    scaled_solvers = phase_solvers_scaled(device, gpu)
    phase_minres_scaled(device, gpu)
    ratio_cg_schur = phase_ratio_anchor(device, gpu, solver="cg-schur",
                                        rtol=RATIO_ANCHOR_CG_SCHUR_RTOL)
    minres_box = phase_minres_box(device, gpu)
    agglomerated, k2_agglomerated, ctx = phase_unstructured_agglomerated(device, gpu)
    hybrid_agglomerated = phase_hybrid_agglomerated(ctx, device, gpu)
    nested, k2_nested, ctx = phase_unstructured_nested(device, gpu)
    hybrid_nested = phase_hybrid_nested(ctx, device, gpu)
    del ctx
    mesh_files, k2_mesh_files = phase_mesh_files(device, gpu)
    if jax_modules_loaded():
        fail(f"imported {jax_modules_loaded()}")

    # launches: the ratio run on the full SPE10 grid; launches_by_path
    # lists every path, this slice's (sharded_golden_mlmc,
    # unstructured_agglomerated_mlmc, unstructured_nested_pair_step)
    # included, each run with the counts set to 0 just before it. The numbers of thomas and threefry_normal are at that grid's
    # shapes, taken in the full-grid MLMC phase:
    # max_abs_err over its three levels; ms, plain_ms, bound_ms and
    # library_ms at level 0 (thomas: one M(w)^{-1} apply, three launches).
    by_path = lambda k: {"golden_mlmc": golden[k], "sharded_golden_mlmc": sharded[k],
                         "unstructured_agglomerated_mlmc": agglomerated[k],
                         "unstructured_nested_pair_step": nested[k],
                         "hybrid_agglomerated_mlmc": hybrid_agglomerated[k],
                         "hybrid_nested_pair_step": hybrid_nested[k],
                         **{f"mesh_file_{name}_mlmc": n[k] for name, n in mesh_files.items()},
                         "spe10_anchor": anchor[k],
                         "spe10_full_grid": full[k], "ratio_anchor": ratio_anchor[k],
                         "ratio_full_grid": ratio_full[k],
                         **{f"sampler_{name}_mlmc": n[k] for name, n in samplers.items()},
                         "static_mg_full_grid": static_full[k],
                         "ratio_anchor_cg_schur": ratio_cg_schur[k],
                         "minres_and_cg_schur_64_box": minres_box[k],
                         **{f"scaled_anchor_{name}": n[k] for name, n in scaled_solvers.items()}}
    on_path = ("the full SPE10 grid, whose MLMC and ratio runs give the kernels the same shapes: "
               "every level at its production batch, float32; times at level 0")
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    k1, k2 = checks["thomas"], checks["threefry_normal"]
    report = {"kernels": [
        {"name": "thomas", "route": "cuda",
         "source": "parelagmc_tpu_torch/csrc/thomas.cu",
         "replaces": "parelagmc_tpu/ops/tridiag_pallas.py:77",
         "launches": ratio_full["thomas"],
         # The full-grid steps of phase 13b count K1 alone, per step.
         "launches_by_path": {**by_path("thomas"), **{
             f"full_grid_{name}_steps": n for name, n in full_solvers.items()}},
         **{k: k1[k] for k in fields}, "bound_by": "bytes",
         # M(w)^{-1} on the golden level-0 tables at one shard's batch.
         "sharded_golden_shard": {k: sharded_checks["thomas"][k] for k in fields},
         # Several right-hand sides per table set: R = 2 on the level-0
         # M(w)^{-1} tables (batch 8), R = batch on the static MG's line
         # tables of the level-1 grid.
         "rhs": [{k: k1["rhs2"][k] for k in ("R", "ms", "plain_ms", "bound_ms", "abs_err")},
                 {k: k1_static[k] for k in ("R", "n", "lines", "ms", "plain_ms", "bound_ms",
                                            "abs_err")}],
         # PyTorch has no batched tridiagonal solve.
         "library_ms": None, "measured_on": on_path},
        {"name": "threefry_normal", "route": "cuda",
         "source": "parelagmc_tpu_torch/csrc/threefry_normal.cu",
         "replaces": "parelagmc_tpu/ops/prng.py:40",
         "launches": ratio_full["threefry_normal"],
         "launches_by_path": by_path("threefry_normal"),
         **{k: k2[k] for k in fields}, "device_ms": k2["device_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"],
         "library_call": "torch.randn (Philox: another generator, not jax.random's values)",
         "measured_on": on_path,
         "sharded_golden_shard": {k: sharded_checks["threefry_normal"][k]
                                  for k in fields + ("device_ms", "library_ms")},
         # The same keys at the draws of the unstructured phases (level 0).
         "unstructured": [{k: r[k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms")}
                          for r in (k2_agglomerated, k2_nested, *k2_mesh_files)]},
        # No path of either package draws uniforms: K3's path is its entry
        # point sample_uniforms, driven in phase 7 with the counts at 0.
        {"name": "threefry_uniform", "route": "cuda",
         "source": "parelagmc_tpu_torch/csrc/threefry_normal.cu",
         "replaces": "parelagmc_tpu/ops/prng.py:127",
         "launches": k3_launches, **{k: k3[k] for k in fields}, "device_ms": k3["device_ms"],
         "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "library_call": "torch.rand (Philox: another generator, not jax.random's values)",
         "measured_on": f"sample_uniforms {K3_SHAPE} float32"},
    ]}
    print(json.dumps(report), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
