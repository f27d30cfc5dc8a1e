#!/usr/bin/env python3
"""Smoke run of the PyTorch port (parelagmc_tpu_torch) on one CUDA card (phase 25:
on every card of the host, a torchrun rank a card).

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
5. bench   - the bench twin, parelagmc_tpu_torch.bench.main(["--device",
             "cuda:0"]): the golden pair step with bench.py's settings
             (batch 512, rtol 1e-4, 50 iterations, local Schur scaling),
             its one JSON line captured (missing, or the E[Q] canary 2.55
             +- 0.12 tripped: the run fails), samples/s, E[Q] and
             vs_baseline printed, K1 and K2 launched. (profile_pair_step.py
             splits this step into layers and device/host time.)
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
             of the pins, consistency < 0.1, both kernels launched, the
             coefMG cycle replayed as CUDA graphs (the f64 state, no cast:
             `coefmg` counters printed, replays > 0); then
             M(w)^{-1} (K1) and K2 against their plain versions at the
             shapes this path gives them (every level's M(w)^{-1} tables
             and noise draw at batch 16, float64).
9. SPE10   - the full 60x220x85 grid with the production solver settings
             (physics/spe10.full_grid_solver_defaults, float32, corlen 100,
             normalized marginals, axis_order auto, synthetic permeability;
             the config from the port's drivers, spe10_mlmc.build_config on
             SPE10_FULL_ARGV and spe10_ratio_mlmc.with_wells, whose
             settings tests/test_torch_examples.py pins): host setup
             seconds, then
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
       per level, peak memory (the coefMG cycle's CUDA graphs included:
       `coefmg` counters printed, replays > 0), CUDA-event ms of one
       level-0 V-cycle; then
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
             --refinements 1 --samples 8 --batch 8 --dtype float64 (the
             config from the port's twin, spe10_ratio_mlmc.build_config,
             pinned by tests/test_torch_examples.py) through
             build_problem, BayesianInverseProblem (the likelihood's
             primal to the example's PRESSURE_RTOL) and BayesRatioManager
             on cg-schur-coefmg: ratio estimate within 2e-3 of 354.436,
             splitting estimate (the same moment table) within 2e-3 of
             350.767, 8 samples per level, E[Z] > 0.01. (The pins were taken
             on "cg-schur": phase 13a.)
12. ratio  - the Bayesian ratio estimators on the full SPE10 grid, this
             slice's full width: phase 9's problem (its config carries the
             three wells of examples/spe10_ratio_mlmc.py, radius 30 ft),
             observation data from one prior draw, the likelihood's
             primal to the example's PRESSURE_RTOL, the example's solver
             canary (8 samples and one likelihood solve per level:
             converged fraction 1.0 required), BayesRatioManager.init_run([8, 128,
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
             execution (one shard per rank, all_gather) runs in phase 25
             under NCCL at world size torch.cuda.device_count(), and the
             line says so.
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
             converged fraction (1.0 required), peak memory (its
             device-busy share is no longer profiled: tracing the step's
             ~3e5 kernels took ~1 min); K2 against its plain version at
             (32, 196 608).
17. hybrid-cg, agglomerated (A) - phase 15's hierarchy and sampler under
             darcy_solver.name "hybrid-cg" (physics/hybrid.py: PCG on the
             face multipliers with Jacobi, constant-mode deflation and the
             graph coefMG as auxiliary-space cycle): which levels hybridize
             geometrically, algebraically or keep MINRES
             (HYBRID_AGGLOMERATED_KINDS, the JAX package's choice); per level
             samples/s, fine/coarse iterations, converged fraction (1.0
             required), device-busy share (the profiler's kernel time over
             the synchronized wall of an unprofiled step, device_busy), peak
             memory, and Q/Qc per sample against minres-coefmg on the same fields and against a deep
             float64 hybrid-cg solve (HYBRID_Q_RTOL: max and median);
             phase 15's level-0 oracle sample against its spsolve
             (UNSTRUCTURED_ORACLE_RTOL; the direct solve is not repeated);
             MLMCManager.init_run of two batches per level (consistency <
             0.1, K2 launched).
18. hybrid-cg, nested (B) - phase 16's level-0 pair step under hybrid-cg:
             samples/s, iterations, converged fraction (1.0 required), the
             Darcy pair's iterations and wall alone, peak memory, printed
             beside phase 16's MINRES numbers (its profiled passes - busy
             share, kernels per PCG iteration, costliest kernels - are cut
             for the script's time, as phase 16's).
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
20. drivers - the port's command-line drivers (parelagmc_tpu_torch/
             examples/), each through its main(argv) in process on the
             default device (cuda:0, no --device given) in a temporary
             directory, the launch counts set to 0 just before each: mlmc
             with no arguments (the golden configuration at full width:
             dofs 17152/2240/304, f32, estimate within 0.25 of 2.56, K1 and
             K2 launched) and the golden keys as a ParameterList read through
             --xml-file (config equal to the default field by field);
             darcy_test --refinements 2 (Q = 2 on every level at 1e-4);
             darcy_random_input and likelihood_example at refinements 2,
             float64, seed 0 (the pins of tests/test_examples.py at 1e-4);
             slmc, mlmc_manual, ratio_estimator_mlmc --splitting and
             ratio_estimator_mc, plain and --splitting, at that file's small
             settings and pins; compute_reference_obs_data (the file, finite);
             sampler_test and realization_test (the VTK and mesh files);
             spe10_mlmc on the 8x12x4 grid (487.129 at rtol 0.01);
             spe10_ratio_mlmc on phase 11's command line under
             cg-schur-coefmg (ratio and splitting estimates equal to phase
             11's to 1e-8 relative). Each run's wall and launches are
             printed; then K1 and K2 against their plain versions at the
             golden driver's shapes (batch 32) and the scaled SPE10 driver's
             (batch 4), float32.
21. spatial sharding (parallel/spatial_darcy.py), stacked on cuda:0 (every
             slab on the one card; torch.cuda.device_count() is printed, and
             the torch.distributed form, one slab a rank, runs in phase 25c
             when there are two cards or more, else in the CPU gloo tests
             only):
   21a. the golden MLMC (float32, cg-schur, rtol 1e-5) unsharded, with
       spatial_shards 4 and with spatial_sample_shards 2 on top: one keyed
       level-0 pair step each with the plain and the adjoint-corrected QoI
       (Q per sample against the unsharded step: SPATIAL_GOLDEN_PLAIN_Q_RTOL
       and SPATIAL_GOLDEN_Q_RTOL; (2, 4) against sp 4 bit for bit or the
       gap printed), then run() each (estimate within 0.25 of 2.56, K1 and
       K2 launched), iterations and launches beside the unsharded run's;
   21b. phase 8's scaled SPE10 anchor with spatial_shards 8 (estimate within
       0.5 of 361.882, E[Q] pins, both kernels launched);
   21c. phase 9's full-grid problem at the production settings: one level-0
       pair step at batch 8, replicated, with spatial_shards 4 and with
       (dp, sp) = (2, 4), at the production settings (Q per sample to
       PRODUCTION_Q_RTOL) and with a float32 state at rtol 1e-5 (to
       SPATIAL_TIGHT_SPREAD); then the same grid built in float64 at rtol
       1e-6 (to TIGHT_Q_RTOL): converged fraction 1.0, iterations, ms per
       step, busy
       share (production), K1 launches, peak memory (stacked: all slabs on
       one card);
   21d. K1 on the sharded M(w)^{-1}'s layouts - slab x lines, z lines (row
       stride m nx), decoupled y lines (row stride nx) and the SPIKE spike
       solves with R = 2 - against thomas_grid_plain, float32 at 21c's
       shapes and float64 at 21b's: max relative error, ms per launch, byte
       bound (5 words per unknown, 7 with R = 2) and its share;
   21e. python -m parelagmc_tpu_torch.examples.spatial_scaling on its
       defaults (60x110x42, 8 slabs, batch 2, float64) in a temporary
       directory: every run's iterations, qoi_rel_err_vs_deep and peak_mb,
       converged fraction 1.0 each.
22. evidence drivers - the port's twins of the JAX package's evidence and
             tuning drivers, each through its main(argv) in process on
             cuda:0 in a temporary working directory (its JSON written
             there), the launch counts set to 0 just before each; rows are
             printed beside the JAX package's TPU evidence files, each
             labelled with its device:
   22a. spe10_performance --selfcheck at its defaults (full grid, 3 levels,
       synthetic permeability): the selfcheck passes, converged 1.0 per
       level, finite fields;
   22b. spe10_sampler_performance at its defaults (60x220x84, batch 256,
       plain/matching/projection): finite moments, each embedded level-0
       field mean within EVIDENCE_EMBED_MEAN_RTOL of the plain one; peak
       memory and host setup per variant;
   22c. (run last) unstructured_performance on the generated six-tet cube
       file, its defaults otherwise (refine 4, 4 agglomerated levels, batch
       128, hybrid-cg, rtol 1e-5) but for the depth of
       EVIDENCE_UNSTRUCTURED_ARGV (256 samples: two timed reps a level):
       QoI oracle within EVIDENCE_ORACLE_RTOL, converged 1.0 per level
       (--compare off: phases 15 and 17 compare the solvers). Its one-core
       scipy baseline is replaced by NaN, and its oracle's sparse LU runs
       in a thread from the start of phase 22 on the same system (taken
       only if bit-equal to the twin's);
   22d. spe10_adjoint_check on the command line of
       SPE10_ADJOINT_EVIDENCE.json (full grid, batch 8, seed 7): every leg
       converged, finite Y, errors and iterations beside the TPU's; then
       its truth pair once more on its float32 fields, in float32 and in
       float64 (which must converge): E[Y] of each and their distance;
   22e. spe10_beta_noise --samples EVIDENCE_BETA_SAMPLES on the full grid
       (a depth cut from 256): the prod leg's Y finite per level; noise
       fraction, correlation, mean iterations per leg, a deep-leg level at
       or above one solve's budget marked;
   22f. spe10_mg_tuning at its defaults (30x110x42, float64, batch 4,
       fourteen variants, rtol 1e-5): every row converges; the measured
       t_schur, t_ovh, t_apply; then --quick (the first three variants) at
       EVIDENCE_MG_DEEP_RTOL, where the converged rows' Q[0] must agree to
       EVIDENCE_MG_Q0_RTOL (at 1e-5 they part by ~2.5e-2: the driver's own
       warning);
   22g. spe10_rate_diagnostics at its defaults (16x56x16, n 64, 3 levels,
       float64): every solve converged;
   22h. after each: K1 and K2 against their plain versions at each distinct
       (configuration, per-level batch, dtype) it launched, on the problem
       it built (recorded through its build_problem), as phase 20 does.
23. graft entry - the graft twin (parelagmc_tpu_torch/graft_entry.py) on
             cuda:0: entry() and one forward step (shapes, finite), then
             dryrun_multichip(GRAFT_DEVICES) with its own checks (sharded
             against unsharded MLMC within 6 standard errors, the
             split_pair_programs run to 5e-4, the (dp, sp) = (2, 4) spatial
             solve cold and warm to 5e-3 with the warm one in <= 1
             iteration), the launch counts set to 0 before each; then K1
             and K2 against their plain versions at each distinct shape of
             those runs: the entry step's (8, 512) draw and M(w)^{-1} at
             8^3 and 4^3 (batch 8); the dry run's MLMC draws and M(w)^{-1}
             on both levels of its 2^3 box at one shard's batch (2) and
             unsharded (16); its unsharded spatial M(w)^{-1} (batch 4) and
             the sharded one's slab layouts (as 21d), all float32.
24. probes - the six SPE10 layer probes (parelagmc_tpu_torch/examples/
             spe10_{level0_breakdown,struct_profile,vcycle_profile,
             iter_cost,level1_cost,layout_probe}) through main(argv) at
             their defaults on cuda:0 (layout_probe without --smoke), the
             launch counts set to 0 just before each; the four level-0
             probes share one build of the full grid (shared_build): every
             number finite, iter_cost's budgets exactly lo and hi
             iterations, every level1_cost batch converged 1.0 at the
             production settings; one line per probe; then K1 and K2
             against their plain versions at each distinct shape of the
             probes (level 0 at batches 8 and 16, levels 1 and 2 at 128).
25. torchrun - the port from its own command line on every card of the
             host: `python -m torch.distributed.run --standalone
             --nproc-per-node N` with N = torch.cuda.device_count(), NCCL,
             a rank a card (parallel/launch.init_from_env through the
             drivers' parse_args); each rank is this script run as
             `chip_smoke.py --torchrun-child KIND OUT_DIR [ARGV]`, which
             writes its numbers to OUT_DIR; a rank that fails, or a launch
             past TORCHRUN_DEADLINE (killed), fails the phase:
   25a. the golden mlmc driver's main with --sample-shards -1 and the
       walltime cost, the launch counts at 0 just before it: dofs
       17152/2240/304, |estimate - 2.56| < 0.25, N_l, C_l and the estimate
       equal on every rank, K1 and K2 launched on every rank (rank 0
       prints them and the driver's wall seconds), MLMC.dat holding each
       sample once; then a fixed-count run (init_run(TORCHRUN_FIXED)) on
       the driver's problem whose per-level sums must equal those of the
       in-process SampleMesh(N) run on the same keys (bit for bit, or
       within TORCHRUN_FIXED_RTOL); then K1 and K2 against their plain
       versions at one rank's shard batch on every level;
   25b. in 25a's launch (each launch pays ~20 s of start-up), the graft
       twin's main (entry(), dryrun_multichip(N), its checks raising) in
       the distributed forms: SampleMesh(N, distributed=True)
       and, for N >= 2, DistributedSlabs; K1 and K2 launched on every rank,
       and held against their plain versions at one rank's shard (batch
       2);
   25c. for N >= 2 only (else one line says it did not run): phase 21c's
       full-grid level-0 pair step at batch TORCHRUN_SPATIAL_BATCH with
       --spatial-shards N a slab a rank against the stacked form in this
       process (Q to PRODUCTION_Q_RTOL), the peak memory of each card
       beside the stacked figures of this phase and of phase 21c.
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

Then one line with each phase's wall seconds, one JSON line with the
kernels' numbers (launches of each path with
the counts at 0 before it, the drivers' as drivers_<run>, `launches` being
the ratio full-grid run's; phase 22's as evidence_<driver>, its checks
under each kernel's "evidence_drivers"; phase 5's as bench_pair_step,
phase 23's as graft_entry_<run>, its checks under "graft_entry"; phase
24's as probes_<probe>, its checks as probes_<probe>_<dtype> entries;
phase 25's rank 0 as torchrun_<run>, its checks under "torchrun"; errors,
ms, plain_ms, bound_ms and library_ms at the full-grid shapes for K1 and K2,
which the MLMC and the ratio run share, of sample_uniforms for K3), the
card's name and power limit, and as the last line {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line; without a CUDA card, or
without the package beside this script, it exits non-zero and prints no
result. It also fails if the JAX package or jax was imported.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
START = time.perf_counter()
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
BIG_REFINEMENTS, BIG_BATCH = 4, 64
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
# tests/test_nondyadic.py:115-131. The pin comes from solves cut at 500
# iterations (both levels run to the limit), so it holds the unconverged
# iterates of the reference's float64 CG, which another package's rounding
# moves by about 1e-3 (the port reads 99934.08 on an H100): rtol 3e-3 here
# against 1e-3 there.
EGG = dict(estimate=99835.47, rtol=3e-3, embedded=[(64, 64, 11), (32, 32, 5)])
RATIO_ANCHOR = dict(ratio=354.436, splitting=350.767, rtol=2e-3)
# The command lines of the port's drivers whose configs phases 9 and 11 take
# (parelagmc_tpu_torch/examples/spe10_mlmc.py, spe10_ratio_mlmc.py).
SPE10_FULL_ARGV = ["--refinements", "2", "--dtype", "float32", "--output", ""]
RATIO_ANCHOR_ARGV = ["--grid", "16,32,8", "--refinements", "1", "--samples", "8", "--batch", "8",
                     "--dtype", "float64", "--output", ""]
# Phase 20: the drivers at the settings of tests/test_examples.py, and its pins.
DRIVER_SMALL = ["--refinements", "1", "--batch", "8", "--samples", "8", "--mse", "0.05"]
DRIVER_GOLDEN_F64 = ["--refinements", "2", "--dtype", "float64", "--seed", "0"]
DRIVER_SAMPLERS = ["--refinements", "1", "--batch", "16", "--samples", "8", "--corlen", "0.4"]
DARCY_RANDOM_PINS = (2.6480155, 2.7483976, 1.8151928)
LIKELIHOOD_PINS = (0.92472297, 0.92566917, 0.92746946)
DRIVER_PIN_RTOL = 1e-4
# The ratio anchor's stream run through the driver against phase 11's run.
DRIVER_RATIO_RTOL = 1e-8
# The golden keys of the reference's test parameters as a ParameterList.
GOLDEN_XML = """<ParameterList name="MLMC golden">
  <ParameterList name="Problem parameters">
    <Parameter name="Correlation length" type="double" value="0.1"/>
    <Parameter name="Variance" type="double" value="1.0"/>
    <Parameter name="Lognormal" type="bool" value="true"/>
    <Parameter name="Sampler name" type="string" value="pde"/>
    <Parameter name="Serial refinement levels" type="int" value="1"/>
    <Parameter name="Parallel refinement levels" type="int" value="1"/>
    <Parameter name="Mean square error" type="double" value="1e-3"/>
    <Parameter name="Number of samples" type="int" value="10"/>
    <Parameter name="Quantity of interest" type="string" value="eff_perm"/>
    <Parameter name="Essential attributes" type="vector_int" value="0 1 1 1 1 0"/>
    <Parameter name="Observational attributes" type="vector_int" value="1 0 0 0 0 0"/>
    <Parameter name="Inflow attributes" type="vector_int" value="0 0 0 0 0 1"/>
    <Parameter name="Output filename for MC managers" type="string" value="MLMC.dat"/>
  </ParameterList>
  <ParameterList name="Bayesian inverse problem parameters">
    <Parameter name="Noise" type="double" value="0.1"/>
    <Parameter name="Number of observational data points" type="int" value="0"/>
  </ParameterList>
</ParameterList>
"""
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
# Phase 21: spatial sharding, stacked on cuda:0. The golden and full-grid
# runs cut y into SPATIAL_SHARDS slabs (with SPATIAL_DP sample rows on top),
# the scaled SPE10 anchor into SPATIAL_ANCHOR_SHARDS. Level-0 Q per sample of
# the sharded golden pair step against the unsharded one, float32 at rtol
# 1e-5 under two preconditioners: the plain flux QoI is only as sharp as the
# residual leaves it on the golden field (float64 solves at rtol 1e-5 miss a
# deep one by up to 4.5e-4 and 2.4e-3; the two float32 steps part by 7.9e-3
# at most, 7.0e-4 median, over 64 samples on a CPU), the adjoint-corrected
# QoI is sharp (2.5e-6 at most there).
SPATIAL_SHARDS, SPATIAL_DP, SPATIAL_ANCHOR_SHARDS = 4, 2, 8
SPATIAL_GOLDEN_PLAIN_Q_RTOL, SPATIAL_GOLDEN_Q_RTOL = 5e-2, 1e-4
# Phase 21c, full grid, sharded against replicated level-0 pair steps (two
# preconditioners: slab Schwarz against the global coefMG). With a float32
# state at rtol 1e-5 the two iterates' adjoint-corrected Q part by 1.87e-5
# (measured on one H100): each is only that close to the solution, so
# that setting is held to SPATIAL_TIGHT_SPREAD; float32 cannot go a decade
# deeper on this grid, so Q is held to TIGHT_Q_RTOL on the grid built in
# float64 at rtol 1e-6 (SPATIAL_F64_ARGV).
SPATIAL_TIGHT_SPREAD = 1e-4
SPATIAL_F64_ARGV = ["--refinements", "2", "--dtype", "float64", "--output", "", "--solver-opt",
                    "coefmg_prec_dtype=", "--solver-opt", "relative_tolerance=1e-6"]
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
# Phase 22: the evidence and tuning drivers at their defaults. 22e's
# samples per level (the original's default 256: a depth cut, PERF.md
# section 4); 22b's embedded level-0 field mean against the plain one; 22f's
# agreement of the converged rows' Q[0] (the driver's own warning), held at
# a deep rtol on the first three variants: at the default 1e-5 the rows
# part by 2.5e-2 on the CPU and on the card alike (PERF.md); 22c's QoI
# oracle (float32 at rtol 1e-5 against the float64 direct solve) and its
# depth cut (two timed reps of 128 samples a level, not four).
EVIDENCE_BETA_SAMPLES = 32
EVIDENCE_EMBED_MEAN_RTOL = 0.05
EVIDENCE_MG_Q0_RTOL = 1e-3
EVIDENCE_MG_DEEP_RTOL = 1e-8
EVIDENCE_ORACLE_RTOL = 1e-4
# 22d: the command line SPE10_ADJOINT_EVIDENCE.json records.
EVIDENCE_ADJOINT_ARGV = ["--plain-rtol", "1e-6", "--truth-rtol", "1e-6"]
EVIDENCE_UNSTRUCTURED_ARGV = ["--samples", "256"]
# 22h times the plain versions once and replays K2's CUDA graph twice (the
# earlier phases: five and ten): a plain draw of 256 x 1.4M normals takes
# ~0.4 s, a replay of 200 kernel launches ~0.3 s.
EVIDENCE_PLAIN_REPS, EVIDENCE_GRAPH_REPLAYS = 1, 2
# Phase 23: dryrun_multichip's device count, that of __graft_entry__.py's
# __main__ (8 virtual CPU devices there; here 8 shards and 8 slab-and-row
# cells stacked on cuda:0).
GRAFT_DEVICES = 8
# Phase 25: the port on every card of the host under torchrun (NCCL, a rank
# a card). The golden mlmc driver's command line (the walltime cost), the
# counts of its fixed-count run (two batches a level), the tolerance of its
# sums against the in-process SampleMesh(N) run's (bit for bit expected at
# N = 1), the batch of 25c's full-grid step (phase 21c's level-0 batch),
# and one launch's deadline (it is killed past it).
TORCHRUN_GOLDEN_ARGV = ["--sample-shards", "-1"]
TORCHRUN_FIXED = [64, 64, 64]
TORCHRUN_FIXED_RTOL = 1e-6
TORCHRUN_SPATIAL_BATCH = 8
TORCHRUN_DEADLINE = 300
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


def coefmg_counts(before: dict) -> dict:
    """The `coefmg` counters' growth since `before` (trace.counter_values()):
    the structured coefMG cycle's graph captures, replays and eager cycles."""
    from parelagmc_tpu_torch.utils import trace

    now = trace.counter_values()
    return {k.split(".", 1)[1]: v - before.get(k, 0) for k, v in now.items()
            if k.startswith("coefmg.")}


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


def k2_check(key, shape, dtype, device, tol: float, label: str, plain_reps: int = 5,
             replays: int = GRAPH_REPLAYS):
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
        device_ms=graph_ms(lambda: prng.sample_normals(key, shape, dtype, device, out=buf),
                           replays=replays),
        plain_ms=cuda_ms(lambda: prng.normals_plain(key, shape, dtype, device), reps=plain_reps),
        # Philox: another generator, so not jax.random's values.
        library_ms=cuda_ms(lambda: torch.randn(shape, dtype=dtype, device=device)))


def k2_line(label: str, r: dict, tol: float, gpu: str) -> str:
    return (f"{label}: scaled_err {r['scaled']:.3e} (tol {tol:g}) kernel {r['ms']:.4f} "
            f"(events around calls) {r['device_ms']:.4f} (device, CUDA graph of {GRAPH_LAUNCHES} "
            f"launches: {100 * r['bound_ms'] / r['device_ms']:.1f}% of bound) "
            f"plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}) "
            f"torch.randn {r['library_ms']:.4f} ms [{gpu}]")


def path_kernel_checks(prob, batches, key, k1_tol: float, k2_tol: float, label: str, gpu: str,
                       solve: bool = True, plain_reps: int = 5, replays: int = GRAPH_REPLAYS,
                       levels=None, draws=None):
    """M(w)^{-1} (K1) and K2 against their plain versions at the shapes a
    path gives them, on every level (or on `levels`, one batch each): K1 on
    the M(w)^{-1} tables factored for a sampled field at the level's batch
    (not where `solve` is false: a path that only draws), K2 on the level's
    noise draw where the path draws (every level, or those in `draws`);
    `plain_reps` timed calls of the plain versions, `replays` of K2's CUDA
    graph. Returns {kernel: first checked level's result dict, with
    max_abs_err the largest over the levels}."""
    from parelagmc_tpu_torch.ops.prng import fold_in

    sampler, solver = prob.sampler, prob.solver
    dtype = solver.dtype
    name = str(dtype).replace("torch.", "")
    out = {}
    for level, batch in zip(range(len(batches)) if levels is None else levels, batches):
        lkey = fold_in(key, level)
        results = []
        if draws is None or level in draws:
            shape = (batch, sampler.sample_size(level))
            _, k2 = k2_check(lkey, shape, dtype, solver.device, k2_tol,
                             f"{label} level {level} {name}", plain_reps, replays)
            print(k2_line(f"{label} level {level} {name}: K2 noise {shape}", k2, k2_tol, gpu),
                  flush=True)
            results.append(("threefry_normal", k2, k2["abs_err"]))
        if solve:
            results.append(("thomas", *level_k1_check(sampler, solver, level, lkey, batch,
                                                       k1_tol, f"{label} level {level}", name,
                                                       gpu, plain_reps)))
        for k, r, err in results:
            if k in out:
                out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err)
            else:
                out[k] = dict(r, max_abs_err=err)
    return out


def level_k1_check(sampler, solver, level: int, key, batch: int, tol: float, label: str,
                   name: str, gpu: str, plain_reps: int = 5):
    """K1 against its plain version on the level's M(w)^{-1} tables factored
    for a sampled field of `batch` samples, with one and with two right-hand
    sides per table set: (result dict, max abs error of both)."""
    import torch

    w = sampler.eval(level, sampler.sample(level, key, batch))
    ms_ = solver.levels[level].mass_solver
    fac = ms_.factor(w)
    k1 = k1_check(ms_, fac, random_rhs(fac, level), tol, f"{label} {name}", plain_reps)
    print(k1_line(f"{label} batch {batch} {name}: K1 M(w)^-1 {ms_.shape} cells", k1, tol, gpu),
          flush=True)
    k1["rhs2"] = k1_rhs_check(ms_, fac, tol, f"{label} batch {batch} {name}", gpu, k1["ms"],
                              plain_reps=min(3, plain_reps))
    del w, fac
    torch.cuda.empty_cache()
    return k1, max(k1["abs_err"], k1["rhs2"]["abs_err"])


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


def phase_bench(gpu: str):
    """Phase 5: the bench twin, parelagmc_tpu_torch.bench.main(["--device",
    "cuda:0"]), with the launch counts set to 0 just before it. Its one JSON
    line is captured and checked (a tripped E[Q] canary exits 1 without it);
    samples/s, E[Q] and vs_baseline are printed beside the card. Returns
    the launches of the run."""
    import io

    from parelagmc_tpu_torch import bench, kernels

    buf = io.StringIO()
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(buf):
            line, eq = bench.main(["--device", "cuda:0"])
    except SystemExit as e:
        fail(f"bench twin exited {e.code} (E[Q] canary tripped, no JSON line)")
    launches = dict(kernels.launch_counts)
    out = buf.getvalue()
    print(out, end="", flush=True)
    printed = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    if printed != [line]:
        fail(f"bench twin printed {printed}, not its one JSON line")
    print(f"bench twin (python -m parelagmc_tpu_torch.bench: golden pair step, batch 512, "
          f"rtol 1e-4, 50 it, local scaling, f32): {line['value']} samples/s, E[Q] {eq:.4f}, "
          f"vs_baseline {line['vs_baseline']} (divisor {line['baseline_sec_per_sample']} "
          f"s/sample, live {line['baseline_sec_per_sample_live']}), device {line['device']}, "
          f"launches {launches} [{gpu}]", flush=True)
    if not (math.isfinite(line["value"]) and line["value"] > 0 and abs(eq - 2.55) <= 0.12):
        fail(f"bench twin: {line['value']} samples/s, E[Q] {eq}")
    for k in ("thomas", "threefry_normal"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the bench twin")
    return launches


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


def phase_spe10_anchor(device, gpu: str, spatial_shards: int = 0):
    """tests/test_spe10_anchor.py::test_spe10_scaled_anchor on the card;
    with `spatial_shards` (phase 21b) level 0 runs sharded into that many
    y-slabs and the kernel checks are left to phase 21d. Returns (launches,
    the kernel checks or None, the problem)."""
    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.physics.spe10 import SPE10_NCELLS, SPE10_SPACING, load_spe10_kinv
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager
    from parelagmc_tpu_torch.utils import trace

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
    cfg.darcy_solver.spatial_shards = spatial_shards
    prob = build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid), device=device)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    kernels.reset_launch_counts()
    before = trace.counter_values()
    t0 = time.perf_counter()
    mgr.init_run([32, 32, 32])
    dt = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    graphs = coefmg_counts(before)
    dofs = [prob.solver.num_dofs(l) for l in range(3)]
    eq = [float(x) for x in mgr.eQ]
    cons = float(mgr.consistency.max())
    sharded = (f", level 0 in {spatial_shards} y-slabs of {prob.solver._spatial(0).m} cell "
               f"planes, stacked on one card" if spatial_shards else "")
    print(f"SPE10 scaled anchor (16x32x8, f64, cg-schur-coefmg, rtol 1e-8{sharded}): estimate "
          f"{mgr.estimate:.6f} (pin {SPE10_ANCHOR['estimate']}) E[Q] {[round(x, 4) for x in eq]} "
          f"dofs {dofs} consistency {cons:.4f} iterations {mgr.solver_iterations.tolist()} "
          f"run {dt:.2f} s launches {launches} coefmg {graphs} [{gpu}]", flush=True)
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
    if spatial_shards:
        return launches, None, prob
    if graphs["graph_replays"] <= 0:
        fail(f"SPE10 anchor: the coefMG cycle was never replayed as a graph ({graphs})")
    checks = path_kernel_checks(prob, mgr.level_batch, fold_in(PRNGKey(cfg.seed), 98),
                                F64_TOL_K1, F64_TOL_K2, "SPE10 anchor kernels vs plain", gpu)
    return launches, checks, prob


def spe10_full_problem(device):
    """The full-grid production problem of examples/spe10_mlmc.py and
    examples/spe10_ratio_mlmc.py (--refinements 2 --dtype float32, synthetic
    permeability), its config taken from the port's twins of those drivers
    (spe10_mlmc.build_config, then spe10_ratio_mlmc.with_wells, whose
    settings tests/test_torch_examples.py pins)."""
    from parelagmc_tpu_torch.examples import spe10_mlmc, spe10_ratio_mlmc
    from parelagmc_tpu_torch.problems import build_problem

    cfg, device, kinv, _ = spe10_mlmc.build_config(SPE10_FULL_ARGV + ["--device", str(device)])
    return build_problem(spe10_ratio_mlmc.with_wells(cfg), kinv_ref=kinv, device=device)


def phase_k1_lines(prob, device, gpu: str):
    """K1 on the line tables of the coefMG smoother: struct_mg_setup on a
    sampled full-grid level-1 field (production batch 128), line axes
    "auto", float32 and bfloat16 tables. An isolated check: the production
    settings leave coefmg_line_axes empty, so no run that this script
    drives end to end reaches the line smoother or the bf16 kernel."""
    import torch

    from parelagmc_tpu_torch.examples._evidence import masked_dinv
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
    state = cmg.struct_mg_setup(mg, masked_dinv(solver.levels[level], w))
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
    from parelagmc_tpu_torch.examples._evidence import masked_dinv
    from parelagmc_tpu_torch.ops import coef_multigrid_structured as cmg
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager
    from parelagmc_tpu_torch.utils import trace

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
    before = trace.counter_values()
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
    graphs = coefmg_counts(before)
    print(f"SPE10 full grid coefMG cycles, init_run and the timed batches: {graphs}, "
          f"peak memory {peak_gb:.2f} GB [{gpu}]", flush=True)
    if graphs["graph_replays"] <= 0:
        fail(f"SPE10 full grid: the coefMG cycle was never replayed as a graph ({graphs})")
    # Level-0 layer times at the production batch.
    L0 = solver.levels[0]
    w = sampler.eval(0, sampler.sample(0, fold_in(key, 7), mgr.level_batch[0]))
    fac = L0.mass_solver.factor(w)
    r = torch.randn(w.shape[:-1] + (L0.n_u,), device=device, dtype=w.dtype)
    minv_ms = cuda_ms(lambda: L0.mass_solver.apply_factored(fac, r), reps=10)
    state = cmg.cast_state(cmg.struct_mg_setup(L0.coef_mg, masked_dinv(L0, w, fac)),
                           torch.bfloat16)
    b = torch.randn(w.shape, device=device, dtype=w.dtype)
    vc_ms = cuda_ms(lambda: cmg.struct_v_cycle(L0.coef_mg, state, b.to(torch.bfloat16)), reps=10)
    print(f"SPE10 full grid level 0 batch {mgr.level_batch[0]}: M(w)^-1 apply {minv_ms:.3f} ms, "
          f"coefMG V-cycle (cheb3, bf16 state, {len(L0.coef_mg.levels)} MG levels) "
          f"{vc_ms:.3f} ms (CUDA events); peak memory {peak_gb:.2f} GB [{gpu}]", flush=True)
    del w, fac, r, state, b
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
    1e-3). The config is the port's twin's, spe10_ratio_mlmc.build_config,
    whose settings tests/test_torch_examples.py pins, and the likelihood's
    pressure tolerance the example's, spe10_ratio_mlmc.PRESSURE_RTOL."""
    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.examples import spe10_ratio_mlmc
    from parelagmc_tpu_torch.problems import build_problem
    from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager
    from parelagmc_tpu_torch.uq.ratio_managers import YRATIO, Z

    cfg, device, kinv, _ = spe10_ratio_mlmc.build_config(
        RATIO_ANCHOR_ARGV + ["--solver-opt", f"name={solver}", "--device", str(device)])
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype,
                                 pressure_rtol=spe10_ratio_mlmc.PRESSURE_RTOL)
    mgr = BayesRatioManager(bip, prob.config)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    y = bip.generate_observational_data()
    mgr.init_run([8, 8])
    dt = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    ratio, splitting = mgr.estimate, float(mgr.E[:, YRATIO].sum())
    ez = mgr.E[:, Z].tolist()
    print(f"SPE10 scaled ratio anchor (16x32x8, f64, {solver}, rtol 1e-6, the likelihood's "
          f"primal to {spe10_ratio_mlmc.PRESSURE_RTOL:g}): observation "
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
    return launches, (ratio, splitting)


def phase_ratio_full(prob, device, gpu: str):
    """Phase 12: examples/spe10_ratio_mlmc.py --refinements 2 on the full
    grid, one batch per level."""
    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.examples import spe10_ratio_mlmc
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager
    from parelagmc_tpu_torch.uq.ratio_managers import YRATIO, Z
    from parelagmc_tpu_torch.utils import trace

    cfg = prob.config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype,
                                 pressure_rtol=spe10_ratio_mlmc.PRESSURE_RTOL)
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
    extra = trace.counters("krylov")
    for level in range(cfg.nlevels):
        # The example's canary: the likelihood's solve of 8 sampled fields.
        xi = prob.sampler.sample(level, PRNGKey(99 + level), 8)
        n0 = extra["extra_iterations"]
        _, q, _, info = bip.compute_G(level, prob.sampler.eval(level, xi), max_iters=budget,
                                      return_info=True)
        conv, its = float(info.converged.float().mean()), int(info.iterations)
        print(f"SPE10 ratio full grid canary level {level}: converged fraction {conv} "
              f"iterations {its} (budget {budget} each for primal and adjoint; primal to "
              f"{spe10_ratio_mlmc.PRESSURE_RTOL:g}, {extra['extra_iterations'] - n0} "
              f"past the configuration's rtol) E[Q] {float(q.double().mean()):.4f} [{gpu}]",
              flush=True)
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
          f"execution (a shard per rank, all_gather) runs in phase 25 under NCCL at world "
          f"size {torch.cuda.device_count()} [{gpu}]", flush=True)
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
    # No profiled third step (device_busy): tracing its ~3e5 kernels took
    # ~1 min, cut for the script's time; PERF.md keeps the earlier reading.
    busy = "not measured here (the profiled step is cut for the script's time)"
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
    # The Darcy pair alone, on the step's fields. Its profiled passes (busy
    # share, kernels per PCG iteration, top kernels: ~1e5 kernels traced
    # three times) are cut for the script's time; PERF.md keeps the
    # earlier reading.
    s_f, s_c = pair_fields(sampler, 0, fold_in(key, 1), n["batch"])
    t0 = time.perf_counter()
    _, _, i_f, i_c = solver.solve_fwd_pair(0, s_f, s_c)
    torch.cuda.synchronize()
    solve_ms = 1e3 * (time.perf_counter() - t0)
    its = i_f.iterations + i_c.iterations
    print(f"hybrid-cg nested level-0 pair step: levels {kinds}, setup {setup_s:.2f} s, batch "
          f"{n['batch']}, f32, rtol {UNSTRUCTURED['rtol']:g}: {1e3 * n['batch'] / wall_ms:.2f} "
          f"samples/s, iterations (fine/coarse) {iters[0]}/{iters[1]}, converged fraction "
          f"{conv:.4f}, device busy not measured here (the profiled passes are cut for the "
          f"script's time); Darcy pair {its} iterations in {solve_ms:.1f} wall ms; peak memory "
          f"{peak:.2f} GB, "
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


def run_driver(name: str, argv, workdir: str):
    """(return value, stdout, wall s, launches) of the port's driver
    parelagmc_tpu_torch.examples.<name> run in process in `workdir` on its
    default device (cuda:0), the launch counts set to 0 just before it."""
    import contextlib
    import importlib
    import io

    import torch

    from parelagmc_tpu_torch import kernels

    module = importlib.import_module(f"parelagmc_tpu_torch.examples.{name}")
    cwd = os.getcwd()
    buf = io.StringIO()
    os.chdir(workdir)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = module.main(list(argv))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    finally:
        os.chdir(cwd)
    return result, buf.getvalue(), dt, launches


def driver_rows(out: str, ncols: int):
    """The rows of a driver's level table: lines of `ncols` numbers whose
    first is a level index."""
    rows = [line.split() for line in out.splitlines()]
    return [r for r in rows if len(r) == ncols and r[0].isdigit()]


def phase_drivers(gpu: str, ratio_anchor_estimates):
    """Phase 20: the port's command-line drivers (parelagmc_tpu_torch/
    examples/), each run in process on the default device through its
    main(argv) in a temporary directory, the launch counts set to 0 before
    each, held to the pins of tests/test_examples.py; then K1 and K2
    against their plain versions at each distinct (config, per-level
    batch, dtype) of those runs. Returns ({run: launches}, {check:
    results})."""
    import dataclasses
    import tempfile

    import numpy as np

    from parelagmc_tpu_torch.examples import common, sampler_test, spe10_mlmc, spe10_ratio_mlmc
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.problems import build_problem
    from parelagmc_tpu_torch.uq.ratio_managers import YRATIO

    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    t_phase = time.perf_counter()
    runs, walls = {}, {}

    def drive(tag, name, argv, marker):
        result, out, dt, launches = run_driver(name, argv, tmp)
        runs[tag], walls[tag] = launches, round(dt, 3)
        est = result[0] if isinstance(result, tuple) else result
        est = est.estimate if hasattr(est, "estimate") else est
        print(f"drivers {tag}: examples.{name} {' '.join(argv)}: "
              f"{'' if est is None else f'estimate {float(est):.8g} '}{dt:.2f} s "
              f"launches {launches} [{gpu}]", flush=True)
        if marker not in out:
            fail(f"drivers {tag}: no '{marker}' in its output:\n{out[-3000:]}")
        return result, out

    def pin(tag, got, want, rtol=0.0, atol=0.0):
        if not (math.isfinite(got) and abs(got - want) <= atol + rtol * abs(want)):
            fail(f"drivers {tag}: {got} not within atol {atol:g} / rtol {rtol:g} of {want}")

    # The golden configuration at full width, float32, on cuda:0 by default.
    est, out = drive("mlmc", "mlmc", [], "FINAL MLMC ERRORS")
    dofs = [int(x) for x in next(l for l in out.splitlines()
                                 if l.startswith("DOFS in Forward Problem")).split()[-3:]]
    if dofs != [17152, 2240, 304]:
        fail(f"drivers mlmc: dofs {dofs}")
    pin("mlmc", est, 2.56, atol=0.25)
    for k in ("thomas", "threefry_normal"):
        if runs["mlmc"][k] <= 0:
            fail(f"kernel {k} was not launched by the mlmc driver")
    xml = os.path.join(tmp, "golden.xml")
    with open(xml, "w") as f:
        f.write(GOLDEN_XML)
    from_xml, default = common.parse_config(["--xml-file", xml]), common.parse_config([])
    if dataclasses.asdict(from_xml) != dataclasses.asdict(default):
        fail(f"drivers: the golden ParameterList gives {from_xml}, not {default}")
    print(f"drivers mlmc --xml-file: the golden ParameterList's config equals the default "
          f"field by field ({len(dataclasses.fields(default))} fields)", flush=True)

    _, out = drive("darcy_test", "darcy_test", ["--refinements", "2"], "DarcyTest")
    rows = driver_rows(out, 4)
    if [int(r[2]) for r in rows] != [17152, 2240, 304]:
        fail(f"drivers darcy_test: rows {rows}")
    for r in rows:
        pin(f"darcy_test level {r[0]}", float(r[3]), 2.0, rtol=DRIVER_PIN_RTOL)
    for tag, pins, ncols in (("darcy_random_input", DARCY_RANDOM_PINS, 3),
                             ("likelihood_example", LIKELIHOOD_PINS, None)):
        _, out = drive(tag, tag, DRIVER_GOLDEN_F64,
                       "DarcyTest_RandomInput" if ncols else "L = 2 : ")
        if ncols:
            vals = [float(r[1]) for r in driver_rows(out, 3)]
        else:
            vals = [float(l.split(":")[1]) for l in out.splitlines() if l.startswith("L = ")]
        if len(vals) != 3:
            fail(f"drivers {tag}: {out[-2000:]}")
        for level, (got, want) in enumerate(zip(vals, pins)):
            pin(f"{tag} level {level}", got, want, rtol=DRIVER_PIN_RTOL)

    f64 = ["--dtype", "float64", "--seed", "0"]
    for tag, name, argv, marker, want, atol, rtol in (
            ("slmc", "slmc", DRIVER_SMALL, "FINAL SLMC ERRORS", 2.21055, 0.02, 0.0),
            ("mlmc_manual", "mlmc_manual", DRIVER_SMALL, "MLMC estimate", 2.48959, 0.02, 0.0),
            ("ratio_estimator_mlmc_splitting", "ratio_estimator_mlmc",
             DRIVER_SMALL + ["--splitting"], "Splitting Estimate", 2.29769, 0.02, 0.0),
            ("ratio_estimator_mc", "ratio_estimator_mc", DRIVER_SMALL + f64,
             "FINAL SL_BayesRatio_Manager ERRORS", 2.24332, 0.0, 0.05),
            ("ratio_estimator_mc_splitting", "ratio_estimator_mc",
             DRIVER_SMALL + f64 + ["--splitting"], "Splitting Estimate", 2.24155, 0.0, 0.05)):
        est, _ = drive(tag, name, argv, marker)
        pin(tag, float(est), want, rtol=rtol, atol=atol)

    _, out = drive("compute_reference_obs_data", "compute_reference_obs_data",
                   ["--refinements", "1"] + f64, "reference observational data")
    data = np.loadtxt(os.path.join(tmp, out.split("-> ")[1].split(":")[0]))
    if not np.isfinite(data).all():
        fail(f"drivers compute_reference_obs_data: {data}")
    _, out = drive("sampler_test", "sampler_test", DRIVER_SAMPLERS, "SPDE-projection")
    if sum("||E[s]-exact||" in l for l in out.splitlines()) != 10:
        fail(f"drivers sampler_test: {out}")
    _, out = drive("sampler_performance", "sampler_performance",
                   DRIVER_SAMPLERS + ["--samples", "32"], "samples/sec")
    if len(driver_rows(out, 4)) != 2:
        fail(f"drivers sampler_performance: {out}")
    drive("realization_test", "realization_test", ["--refinements", "1"], "saved realization")
    for f in ("realization_L00.vtk", "realization_mesh_L00.mesh", "realization_L00.gf",
              "realization_L01.vtk"):
        if not os.path.isfile(os.path.join(tmp, f)):
            fail(f"drivers realization_test: {f} not written")
    with open(os.path.join(tmp, "realization_L00.vtk")) as fh:
        vtk = fh.read()
    if "RECTILINEAR_GRID" not in vtk or "CELL_DATA" not in vtk:
        fail("drivers realization_test: not a VTK cell field")

    spe10_small = ["--grid", "8,12,4", "--refinements", "1", "--samples", "4", "--batch", "4",
                   "--mse", "1e10"]
    mgr, _ = drive("spe10_mlmc", "spe10_mlmc", spe10_small, "Estimate")
    pin("spe10_mlmc", mgr.estimate, 487.129, rtol=0.01)
    out_json = os.path.join(tmp, "ratio.json")
    ratio_argv = RATIO_ANCHOR_ARGV + ["--solver-opt", "name=cg-schur-coefmg"]
    (ratio, mgr), _ = drive("spe10_ratio_mlmc", "spe10_ratio_mlmc",
                            ratio_argv + ["--out", out_json], "FINAL ML_BayesRatio_Manager ERRORS")
    splitting = float(mgr.E[:, YRATIO].sum())
    for what, got, want in (("ratio", ratio, ratio_anchor_estimates[0]),
                            ("splitting", splitting, ratio_anchor_estimates[1])):
        pin(f"spe10_ratio_mlmc {what} against phase 11", got, want, rtol=DRIVER_RATIO_RTOL)
    with open(out_json) as fh:
        if json.load(fh)["posterior_estimate"] != ratio:
            fail("drivers spe10_ratio_mlmc: evidence file does not hold the estimate")
    print(f"drivers spe10_ratio_mlmc: ratio {ratio!r} splitting {splitting!r} against phase "
          f"11's {ratio_anchor_estimates[0]!r} {ratio_anchor_estimates[1]!r} (rtol "
          f"{DRIVER_RATIO_RTOL:g})", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    drivers_s = time.perf_counter() - t_phase

    # K1 and K2 against their plain versions at each distinct (config,
    # per-level batch, dtype) the runs above give them: K1 picks its group
    # from the launch shape, so batch 1 and batch 32 are checks of their own.
    checks, covered = {}, set()

    def check(tag, cfg, dev, batches, runs_, kinv=None, solve=True):
        wide = cfg.dtype == "float64"
        checks[tag] = path_kernel_checks(
            build_problem(cfg, kinv_ref=kinv, device=dev), batches,
            fold_in(PRNGKey(cfg.seed), 97), F64_TOL_K1 if wide else F32_TOL_K1,
            F64_TOL_K2 if wide else F32_TOL_K2, f"drivers {tag}", gpu, solve=solve)
        covered.update(runs_)
        print(f"drivers {tag}: the shapes of {', '.join(runs_)}", flush=True)

    ratio_runs = ("ratio_estimator_mc", "ratio_estimator_mc_splitting")
    for tag, argv, batch, nlevels, runs_ in (
            ("golden_f32_batch32", [], 32, 3, ("mlmc",)),
            ("golden_f32_batch1", ["--refinements", "2"], 1, 3, ("darcy_test",)),
            ("golden_f64_batch1", DRIVER_GOLDEN_F64, 1, 3,
             ("darcy_random_input", "likelihood_example")),
            ("small_f32_batch8", DRIVER_SMALL, 8, 2,
             ("slmc", "mlmc_manual", "ratio_estimator_mlmc_splitting")),
            # One draw per level; the observational data of the ratio run.
            ("small_f32_batch1", ["--refinements", "1"], 1, 2,
             ("realization_test", "ratio_estimator_mlmc_splitting")),
            ("small_f64_batch8", DRIVER_SMALL + f64, 8, 2, ratio_runs),
            # The observational data: one solve on level 0.
            ("small_f64_batch1", ["--refinements", "1"] + f64, 1, 1,
             ("compute_reference_obs_data",) + ratio_runs)):
        cfg, dev = common.parse_args(argv)
        check(tag, cfg, dev, [batch] * nlevels, runs_)
    cfg, dev = common.parse_args(DRIVER_SAMPLERS)
    for name, kw in sampler_test.VARIANTS:
        # The samplers draw and solve nothing: K2 alone.
        check(f"sampler_test_{name}", dataclasses.replace(cfg, **kw), dev, [16, 16],
              ("sampler_test",) + (("sampler_performance",) if name == "SPDE" else ()),
              solve=False)
    cfg, dev, kinv, _ = spe10_mlmc.build_config(spe10_small)
    check("spe10_scaled_f32_batch4", cfg, dev, [cfg.batch_size] * cfg.nlevels, ("spe10_mlmc",),
          kinv)
    cfg, dev, kinv, _ = spe10_ratio_mlmc.build_config(ratio_argv)
    check("spe10_ratio_f64_batch8", cfg, dev, [8, 8], ("spe10_ratio_mlmc",), kinv)
    check("spe10_ratio_f64_batch1", cfg, dev, [1], ("spe10_ratio_mlmc",), kinv)
    if covered != set(runs):
        fail(f"drivers: runs {sorted(set(runs) - covered)} have no kernel check at their shapes")
    print(f"drivers: {len(runs)} runs in {drivers_s:.2f} s, phase with the kernel checks "
          f"{time.perf_counter() - t_phase:.2f} s; wall per run {walls} [{gpu}]", flush=True)
    return runs, checks


def spatial_k1_checks(sd, w, tol: float, label: str, gpu: str):
    """Phase 21d: K1 on the layouts of the sharded M(w)^{-1} - the slab x
    lines, the z lines (row stride m nx), the decoupled y lines (row stride
    nx) and the SPIKE spike solves with R = 2 right-hand sides per table set
    - on the tables SpatialDarcy factors for the fields w, against
    thomas_grid_plain on the same inputs. Prints one line per layout;
    returns {layout: dict with max_rel_err, max_abs_err, ms, plain_ms,
    bound_ms}. Fails above `tol`."""
    import torch

    from parelagmc_tpu_torch.ops.tridiag_pallas import thomas_grid, thomas_grid_plain

    g = sd.grids
    wg = sd._to_slabs(w.reshape(-1, sd.n_s), 1.0, slice(None)).masked_fill(g.pad_cell, 1.0)
    fx, fy, fz = sd._minv_factor(g, wg, sd.comm.halo_up(wg.narrow(-2, sd.m - 1, 1)))
    flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
    gen = torch.Generator(device=wg.device).manual_seed(21)
    layouts = (("x lines", fx, 3, 1), ("z lines", fz, 1, 1),
               ("y lines, decoupled", (fy.dl_in, fy.d, fy.du_in), 2, 1),
               ("spike solves, R = 2", (fy.dl_in, fy.d, fy.du_in), 2, 2))
    out = {}
    for name, tabs, dim, R in layouts:
        tabs = [flat(t).contiguous() for t in tabs]
        shape = tuple(tabs[1].shape)
        b = torch.randn((shape[0], R) + shape[1:] if R > 1 else shape, generator=gen,
                        device=wg.device, dtype=wg.dtype)
        x = thomas_grid(*tabs, b, dim)
        ref = thomas_grid_plain(*tabs, b, dim)
        torch.cuda.synchronize()
        if not torch.isfinite(x).all():
            fail(f"K1 {label} {name}: non-finite output")
        abs_err = (x - ref).abs().max().item()
        rel = abs_err / ref.abs().max().item()
        ms = cuda_ms(lambda: thomas_grid(*tabs, b, dim))
        plain_ms = cuda_ms(lambda: thomas_grid_plain(*tabs, b, dim), reps=3)
        n = tabs[1].numel()
        bound = bytes_bound_ms(k1_rhs_bytes(n, R, b.element_size()))
        out[name] = dict(max_rel_err=rel, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, R=R, lines=n // shape[dim], n=shape[dim])
        print(f"K1 {label} {name} (tables {shape}, {n // shape[dim]} lines of {shape[dim]}, "
              f"R {R}, {3 + 2 * R} words per unknown): max_rel_err {rel:.3e} (tol {tol:g}) "
              f"kernel {ms:.4f} plain {plain_ms:.4f} bound {bound:.4f} ms/launch "
              f"({100 * bound / ms:.1f}% of bound) [{gpu}]", flush=True)
        if not rel <= tol:
            fail(f"K1 {label} {name}: rel err {rel} > {tol}")
    return out


def phase_spatial_golden(device, gpu: str):
    """Phase 21a: the golden MLMC (full width, float32, cg-schur at rtol
    1e-5) unsharded, with spatial_shards = SPATIAL_SHARDS, and with
    spatial_sample_shards = SPATIAL_DP on top, all on cuda:0 in the stacked
    form: one level-0 pair step on a fixed key, with the plain and with the
    adjoint-corrected QoI (Q per sample of the sharded runs against the
    unsharded one: SPATIAL_GOLDEN_PLAIN_Q_RTOL, SPATIAL_GOLDEN_Q_RTOL), and
    an adaptive run() each (estimate within 0.25 of 2.56). Returns {run:
    launches of its run()}."""
    import dataclasses

    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.problems import ProblemConfig, build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg = ProblemConfig(refinements=2)
    cfg.darcy_solver.relative_tolerance = 1e-5
    cfg.output_filename = ""
    prob = build_problem(cfg, device=device)
    solver = prob.solver
    base = solver.solver_cfg
    key = fold_in(PRNGKey(41), 0)
    sp, dp = SPATIAL_SHARDS, SPATIAL_DP
    runs = (("unsharded", {}), (f"sp{sp}", dict(spatial_shards=sp)),
            (f"dp{dp}_sp{sp}", dict(spatial_shards=sp, spatial_sample_shards=dp)))
    res = {}
    for name, kw in runs:
        r = res[name] = {}
        for qoi, adjoint in (("adjoint", True), ("plain", False)):
            solver.solver_cfg = dataclasses.replace(base, adjoint_qoi=adjoint, **kw)
            mgr = MLMCManager(solver, prob.sampler, cfg)
            q, qc, its = mgr._step(0)(key)
            r[qoi] = dict(q=q.double(), qc=qc.double(), its=float(its.mean()))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r["est"] = mgr.run()
        r.update(dt=time.perf_counter() - t0, launches=dict(kernels.launch_counts),
                 iterations=[round(float(x), 1) for x in mgr.solver_iterations],
                 samples=mgr.level_nsamples.tolist())
    solver.solver_cfg = base
    ref = res["unsharded"]
    for name, r in res.items():
        print(f"spatial golden MLMC [{name}]: estimate {r['est']:.6f} samples {r['samples']} "
              f"mean iterations per level {r['iterations']} run {r['dt']:.2f} s launches K1 "
              f"{r['launches']['thomas']} K2 {r['launches']['threefry_normal']}; level-0 pair "
              f"step (batch {cfg.batch_size}) mean fine + coarse iterations: plain "
              f"{r['plain']['its']:.1f}, adjoint (primal + adjoint) {r['adjoint']['its']:.1f} "
              f"[{gpu}]", flush=True)
        if not math.isfinite(r["est"]) or abs(r["est"] - 2.56) >= 0.25:
            fail(f"spatial golden [{name}]: estimate {r['est']} not within 0.25 of 2.56")
        if name == "unsharded":
            continue
        for k in ("thomas", "threefry_normal"):
            if r["launches"][k] <= 0:
                fail(f"kernel {k} was not launched by the spatial golden MLMC run [{name}]")
        for qoi, tol in (("plain", SPATIAL_GOLDEN_PLAIN_Q_RTOL),
                         ("adjoint", SPATIAL_GOLDEN_Q_RTOL)):
            a, b = r[qoi], ref[qoi]
            rel = (a["q"] - b["q"]).abs() / b["q"].abs()
            same_c = torch.equal(a["qc"], b["qc"])
            print(f"spatial golden level-0 step [{name}] [{qoi} QoI] against the unsharded step "
                  f"on the same key: rel Q diff max {rel.max().item():.3e} (tol {tol:g}) median "
                  f"{rel.median().item():.3e}, coarse Q {'identical' if same_c else 'differs'} "
                  f"[{gpu}]", flush=True)
            if not (torch.isfinite(a["q"]).all() and rel.max().item() <= tol and same_c):
                fail(f"spatial golden [{name}] [{qoi}]: level-0 Q differs from the unsharded "
                     f"step by {rel.max().item()}")
    for qoi in ("plain", "adjoint"):
        a, b = res[f"sp{sp}"][qoi]["q"], res[f"dp{dp}_sp{sp}"][qoi]["q"]
        gap = "bit for bit" if torch.equal(a, b) else \
            f"max rel diff {((a - b).abs() / a.abs()).max().item():.3e}"
        print(f"spatial golden level-0 step [{qoi} QoI] (dp, sp) = ({dp}, {sp}) against sp {sp} "
              f"alone: {gap} [{gpu}]", flush=True)
    print(f"spatial golden: torch.cuda.device_count() {torch.cuda.device_count()}; every run "
          f"stacked on cuda:0; the torch.distributed form (one slab per rank) runs on the cards "
          f"in phase 25c only with two or more of them, else in the CPU tests "
          f"(tests/test_torch_spatial.py, tests/test_torch_launch.py: gloo processes) [{gpu}]",
          flush=True)
    return {name: r["launches"] for name, r in res.items() if name != "unsharded"}


def spatial_step_compare(prob, device, gpu: str, label: str, override: dict, tol: float,
                         busy: bool = False):
    """One level-0 pair step of `prob` at its level-0 batch on a fixed key,
    replicated, with spatial_shards = SPATIAL_SHARDS and with (dp, sp) =
    (SPATIAL_DP, SPATIAL_SHARDS), each with the solver settings `override`:
    Q per sample of the sharded steps against the replicated one to `tol`,
    converged fraction 1.0, iterations, ms per step (after a first call
    that builds the SpatialDarcy and warms up), the busy share (`busy`), K1
    launches and peak memory. Returns (the K1 launches of the sharded steps,
    the peak GB of the sp-only stacked step)."""
    import dataclasses

    import torch

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg, solver, sampler = prob.config, prob.solver, prob.sampler
    batch = cfg.batch_size_per_level[0]
    budget = MLMCManager(solver, sampler, cfg).pair_budget
    step = level_step(solver, sampler, 0, fold_in(PRNGKey(cfg.seed), 121), batch, budget)
    base = solver.solver_cfg
    sp, dp = SPATIAL_SHARDS, SPATIAL_DP
    res = {}
    for name, kw in (("replicated", {}), (f"sp {sp}", dict(spatial_shards=sp)),
                     (f"(dp, sp) ({dp}, {sp})", dict(spatial_shards=sp,
                                                     spatial_sample_shards=dp))):
        solver.solver_cfg = dataclasses.replace(base, **override, **kw)
        t0 = time.perf_counter()
        step()  # builds the SpatialDarcy of this setting (host setup) and warms up
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        q, infos = step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n_k1 = kernels.launch_counts["thomas"]
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        busy_share = device_busy(step, ms)[0] if busy else None
        conv = float(torch.cat([i.converged.float() for i in infos]).mean())
        res[name] = dict(q=q.double(), its=[i.iterations for i in infos], ms=ms, n_k1=n_k1,
                         conv=conv, peak=peak_gb, busy=busy_share, setup=setup_s)
    solver.solver_cfg = base
    solver._spatial_cache.clear()
    ref = res["replicated"]
    for name, r in res.items():
        rel = ((r["q"] - ref["q"]).abs() / ref["q"].abs()).max().item()
        share = "not measured" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
        mem = "stacked: all slabs on one card" if name != "replicated" else "replicated"
        print(f"spatial SPE10 full grid level-0 pair step batch {batch} [{label}] [{name}]: "
              f"max rel Q diff vs replicated {rel:.3e} (tol {tol:g}) iterations (coarse, fine; "
              f"primal + adjoint) {r['its']} converged fraction {r['conv']} step "
              f"{r['ms']:.1f} ms ({r['ms'] / batch:.2f} ms/sample, first call incl. setup "
              f"{r['setup']:.2f} s) busy {share} K1 launches {r['n_k1']} peak memory "
              f"{r['peak']:.2f} GB ({mem}) [{gpu}]", flush=True)
        if r["conv"] < 1.0 or not torch.isfinite(r["q"]).all():
            fail(f"spatial full grid [{label}] [{name}]: converged fraction {r['conv']}")
        if name != "replicated" and not rel <= tol:
            fail(f"spatial full grid [{label}] [{name}]: Q differs from the replicated step "
                 f"by {rel}")
    a, b = res[f"sp {sp}"]["q"], res[f"(dp, sp) ({dp}, {sp})"]["q"]
    gap = "bit for bit" if torch.equal(a, b) else \
        f"max rel diff {((a - b).abs() / a.abs()).max().item():.3e}"
    print(f"spatial SPE10 full grid [{label}]: (dp, sp) = ({dp}, {sp}) against sp {sp} alone: "
          f"{gap} [{gpu}]", flush=True)
    return (sum(r["n_k1"] for name, r in res.items() if name != "replicated"),
            res[f"sp {sp}"]["peak"])


def phase_spatial_full(prob, device, gpu: str):
    """Phase 21c on phase 9's full-grid problem (float32): the level-0 pair
    step replicated and sharded (spatial_step_compare) at the production
    settings (Q per sample to PRODUCTION_Q_RTOL, busy share) and with a
    float32 state at rtol 1e-5 (to SPATIAL_TIGHT_SPREAD); then 21d in
    float32 at these shapes. Returns (K1 launches of the sharded steps,
    the 21d results, the stacked sp step's peak GB at the production
    settings)."""
    import dataclasses

    import torch

    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    launches, stacked_peak = spatial_step_compare(prob, device, gpu, "production", {},
                                                  PRODUCTION_Q_RTOL, busy=True)
    launches += spatial_step_compare(prob, device, gpu, "float32 state, rtol 1e-5",
                                     TIGHT_SETTINGS, SPATIAL_TIGHT_SPREAD)[0]
    if launches <= 0:
        fail("kernel thomas was not launched by the sharded full-grid steps")
    solver, sampler = prob.solver, prob.sampler
    base = solver.solver_cfg
    batch = prob.config.batch_size_per_level[0]
    solver.solver_cfg = dataclasses.replace(base, spatial_shards=SPATIAL_SHARDS)
    sd = solver._spatial(0)
    w = sampler.eval(0, sampler.sample(0, fold_in(PRNGKey(prob.config.seed), 122), batch))
    layouts = spatial_k1_checks(sd, w, F32_TOL_K1, f"sharded M(w)^-1 SPE10 full grid level 0 "
                                f"sp {SPATIAL_SHARDS} batch {batch} float32", gpu)
    solver.solver_cfg = base
    del sd, w
    solver._spatial_cache.clear()
    torch.cuda.empty_cache()
    return launches, layouts, stacked_peak


def phase_spatial_full_f64(device, gpu: str) -> int:
    """Phase 21c in float64: the full SPE10 grid built in float64 with a
    float64 MG state at rtol 1e-6 (float32 stalls there: converged 0.19 at
    rtol 1e-6, measured on one H100), the level-0 pair step replicated and
    sharded with Q per sample to TIGHT_Q_RTOL. Returns the sharded steps'
    K1 launches."""
    import torch

    from parelagmc_tpu_torch.examples import spe10_mlmc
    from parelagmc_tpu_torch.problems import build_problem

    cfg, device, kinv, _ = spe10_mlmc.build_config(SPATIAL_F64_ARGV + ["--device", str(device)])
    t0 = time.perf_counter()
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    print(f"spatial SPE10 full grid float64: host setup {time.perf_counter() - t0:.2f} s "
          f"[{gpu}]", flush=True)
    launches = spatial_step_compare(prob, device, gpu, "float64, float64 state, rtol 1e-6", {},
                                    TIGHT_Q_RTOL)[0]
    del prob
    torch.cuda.empty_cache()
    return launches


def phase_spatial_anchor_layouts(prob, gpu: str):
    """Phase 21d in float64: K1 on the sharded layouts at the scaled SPE10
    anchor's level-0 shapes (phase 21b's problem, its level batch)."""
    from parelagmc_tpu_torch.ops.prng import PRNGKey

    sd = prob.solver._spatial(0)
    batch = prob.config.batch_size
    w = prob.sampler.eval(0, prob.sampler.sample(0, PRNGKey(123), batch))
    return spatial_k1_checks(sd, w, F64_TOL_K1, f"sharded M(w)^-1 scaled SPE10 anchor level 0 "
                             f"sp {sd.n_sp} batch {batch} float64", gpu)


def phase_spatial_scaling(gpu: str):
    """Phase 21e: the port's spatial_scaling driver on its defaults (60 x
    110 x 42, 8 slabs, batch 2, float64, cuda:0) in a temporary directory.
    Returns its runs."""
    import tempfile

    from parelagmc_tpu_torch.examples import spatial_scaling

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = spatial_scaling.main(["--out", os.path.join(tmp, "spatial.json")])
        dt = time.perf_counter() - t0
    for tag, r in res["runs"].items():
        peak = "-" if r["peak_mb"] is None else f"{r['peak_mb']:.1f}"
        print(f"spatial_scaling {res['grid']} {res['shards']} slabs batch {res['batch']} "
              f"{res['dtype']} [{tag}]: iterations {r['iterations']} converged fraction "
              f"{r['converged_fraction']} qoi_rel_err_vs_deep {r['qoi_rel_err_vs_deep']:.3e} "
              f"peak_mb {peak} ({r['execution']}"
              f"{': all slabs on one card' if r['execution'] == 'stacked' else ''}) [{gpu}]",
              flush=True)
        if r["converged_fraction"] < 1.0 or not math.isfinite(r["qoi_rel_err_vs_deep"]):
            fail(f"spatial_scaling [{tag}]: {r}")
    print(f"spatial_scaling driver: {dt:.2f} s [{gpu}]", flush=True)
    return res["runs"]


class recording:
    """Context: `module.<attr>` (a builder) wrapped to keep the first `keep`
    objects it returns, each handed to `on_build` first (if given); the
    original is back on exit."""

    def __init__(self, module, attr: str, keep: int = 1, on_build=None):
        self.module, self.attr, self.keep, self.on_build = module, attr, keep, on_build
        self.built = []

    def __enter__(self):
        self.real = getattr(self.module, self.attr)

        def wrapper(*args, **kw):
            out = self.real(*args, **kw)
            if self.on_build is not None:
                self.on_build(out)
            if len(self.built) < self.keep:
                self.built.append(out)
            return out

        setattr(self.module, self.attr, wrapper)
        return self.built

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)
        return False


@contextlib.contextmanager
def replaced(module, attr: str, value):
    """Context: `module.<attr>` is `value` inside, the original after."""
    real = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield real
    finally:
        setattr(module, attr, real)


def tpu_record(name: str):
    """The JAX package's evidence file `name` (taken on a TPU v5e), or None."""
    path = os.path.join(HERE, name)
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def evidence_run(name: str, argv, workdir: str, record=None, keep: int = 1, on_build=None):
    """(return value, stdout, wall s, launches, recorded problems) of the
    twin parelagmc_tpu_torch.examples.<name> through run_driver, with the
    build_problem of the examples module `record` (the twin's own by
    default; none when `record` is False) recorded."""
    import contextlib
    import importlib

    watch = contextlib.nullcontext([])
    if record is not False:
        module = importlib.import_module(f"parelagmc_tpu_torch.examples.{record or name}")
        watch = recording(module, "build_problem", keep, on_build)
    with watch as built:
        result = run_driver(name, argv, workdir)
    print(f"evidence {name} {' '.join(argv)}: {result[2]:.2f} s, launches {result[3]}",
          flush=True)
    return (*result, built)


def evidence_checks(tag: str, prob, batches, gpu: str, solve: bool = True, **where):
    """Phase 22h (and 24's): K1 and K2 against their plain versions at a
    twin's shapes (path_kernel_checks on the problem it built; `where`: its
    levels and draws)."""
    import torch

    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    wide = prob.dtype == torch.float64
    out = path_kernel_checks(prob, batches, fold_in(PRNGKey(prob.config.seed), 97),
                             F64_TOL_K1 if wide else F32_TOL_K1,
                             F64_TOL_K2 if wide else F32_TOL_K2, f"evidence {tag}", gpu,
                             solve=solve, plain_reps=EVIDENCE_PLAIN_REPS,
                             replays=EVIDENCE_GRAPH_REPLAYS, **where)
    torch.cuda.empty_cache()
    return out


def ms_text(sec: float) -> str:
    """Seconds as milliseconds, three decimals."""
    return f"{sec * 1e3:.3f}"


def phase_evidence_performance(gpu: str, tmp: str):
    """Phase 22a: spe10_performance --selfcheck at its defaults (the full
    60x220x85 grid, 3 levels, synthetic permeability): the selfcheck, every
    level's pair converged 1.0, finite fields; its rows beside the JAX
    package's TPU rows. Then 22h at its shapes."""
    out_json = os.path.join(tmp, "SPE10_EVIDENCE_TORCH.json")
    ev, out, _, launches, built = evidence_run(
        "spe10_performance", ["--selfcheck", "--out", out_json], tmp)
    if out.count("batch1-vs-batch2[0] rel diff") != 3 or out.count(" ok\n") < 3:
        fail(f"22a: selfcheck did not pass:\n{out[-3000:]}")
    tpu = tpu_record("SPE10_EVIDENCE.json")
    for row in ev["levels"]:
        pair, se = row["mlmc_pair"], row["sample_eval"]
        if pair["converged_fraction"] != 1.0 or not math.isfinite(se["field_mean"]):
            fail(f"22a spe10_performance level {row['level']}: {row}")
        line = (f"22a spe10_performance level {row['level']} ({row['darcy_dofs']} dofs, pair batch "
                f"{row['batch']}): [{ev['device']}] Sample+Eval {ms_text(se['sec_per_sample'])} "
                f"ms/sample, pair {ms_text(pair['sec_per_sample'])} ms/sample, iterations "
                f"{pair['mean_iterations']:.2f}, converged {pair['converged_fraction']}, "
                f"field mean {se['field_mean']:.6g}")
        if tpu is not None:
            t = tpu["levels"][row["level"]]
            line += (f"; [TPU v5e, JAX package, SPE10_EVIDENCE.json] Sample+Eval "
                     f"{ms_text(t['sample_eval']['sec_per_sample'])}, pair "
                     f"{ms_text(t['mlmc_pair']['sec_per_sample'])} ms/sample, iterations "
                     f"{t['mlmc_pair']['mean_iterations']:.2f}")
        print(line, flush=True)
    prob = built[0]
    checks = {
        "spe10_performance_f32": evidence_checks(
            "spe10_performance pair", prob, [r["batch"] for r in ev["levels"]], gpu),
        "spe10_performance_sample_eval_f32": evidence_checks(
            "spe10_performance Sample+Eval", prob, [ev["config"]["batch"]] * len(ev["levels"]),
            gpu, solve=False)}
    return "spe10_performance", launches, checks


def phase_evidence_sampler(gpu: str, tmp: str):
    """Phase 22b: spe10_sampler_performance at its defaults (60x220x84,
    batch 256, plain/matching/projection): finite moments, each embedded
    variant's level-0 field mean within EVIDENCE_EMBED_MEAN_RTOL of the
    plain one; peak memory and host setup per variant. Then 22h (K2: the
    samplers draw, nothing is solved)."""
    ev, _, _, launches, built = evidence_run(
        "spe10_sampler_performance", ["--out", os.path.join(tmp, "sampler.json")], tmp, keep=3)
    tpu = tpu_record("SPE10_SAMPLER_EVIDENCE.json")
    plain_mean = ev["variants"]["plain"][0]["field_mean"]
    for variant, rows in ev["variants"].items():
        for row in rows:
            if not (math.isfinite(row["field_mean"]) and math.isfinite(row["field_std"])):
                fail(f"22b {variant} level {row['level']}: {row}")
            line = (f"22b spe10_sampler_performance {variant} level {row['level']} "
                    f"({row['solve_dofs']} solve / {row['field_dofs']} field cells, batch "
                    f"{row['batch']}): [{ev['device']}] Sample+Eval "
                    f"{ms_text(row['sample_eval']['sec_per_sample'])} ms/sample"
                    + (f", EmbedEval {ms_text(row['embed_eval']['sec_per_sample'])}"
                       if "embed_eval" in row else "")
                    + (f", projector {ms_text(row['projector_apply']['sec_per_sample'])}"
                       if "projector_apply" in row else "")
                    + f", field mean {row['field_mean']:.6g} std {row['field_std']:.6g}")
            if row["level"] == 0:
                line += (f", peak {row['hbm_bytes'] / 1e9:.3f} GB, host setup "
                         f"{row['setup_sec']:.2f} s")
            if tpu is not None:
                t = tpu["variants"][variant][row["level"]]
                line += (f"; [TPU v5e, JAX package, SPE10_SAMPLER_EVIDENCE.json] Sample+Eval "
                         f"{ms_text(t['sample_eval']['sec_per_sample'])} ms/sample")
            print(line, flush=True)
        if variant != "plain" and abs(rows[0]["field_mean"] - plain_mean) > \
                EVIDENCE_EMBED_MEAN_RTOL * abs(plain_mean):
            fail(f"22b {variant}: level-0 field mean {rows[0]['field_mean']} against the plain "
                 f"{plain_mean}")
    checks = {f"spe10_sampler_{p.config.embedding}_f32": evidence_checks(
        f"spe10_sampler_performance {p.config.embedding}", p,
        [p.config.batch_size] * p.config.nlevels, gpu, solve=False) for p in built}
    return "spe10_sampler_performance", launches, checks


def start_unstructured_oracle(tmp: str):
    """22c's level-0 QoI oracle begun in a thread at the start of phase 22:
    the twin's generated cube file written into `tmp`, its hierarchy and
    float32 operators at its defaults (built on the CPU, with minres-bj,
    which builds no preconditioner: the oracle reads the level's saddle
    system alone), its oracle field, and the twin's oracle_system and
    oracle_solve (one sparse LU on one host core, ~62 s). Returns (mesh
    path, future of ((A, b, obs), Q, LU seconds)); 22c runs last."""
    def solve(mesh):
        import torch

        from parelagmc_tpu_torch.examples import unstructured_performance as up
        from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver

        args = up.build_parser().parse_args(["--mesh", mesh])
        hier, _ = up.read_hierarchy(args)
        solver = UnstructuredDarcySolver(hier, up.problem_config(args, "minres-bj"),
                                         torch.float32, torch.device("cpu"))
        system = up.oracle_system(hier, solver, 0, up.oracle_field(hier, args.variance))
        t0 = time.perf_counter()
        return system, up.oracle_solve(*system), time.perf_counter() - t0

    mesh = os.path.join(tmp, "cube_tet.mesh")
    write_tet_mesh(mesh, *tet_box(1, 0.0, 1.0))
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(solve, mesh)
    pool.shutdown(wait=False)
    return mesh, future


def phase_evidence_unstructured(gpu: str, tmp: str, ahead):
    """Phase 22c: unstructured_performance on the generated six-tet cube
    file, defaults otherwise (refine 4, 4 agglomerated levels, batch 128,
    hybrid-cg, rtol 1e-5, float32) but for EVIDENCE_UNSTRUCTURED_ARGV's
    depth: the level-0 QoI oracle within EVIDENCE_ORACLE_RTOL, converged
    1.0 on every level. The twin's scipy_pair_baseline is replaced by one
    that returns NaN (each level-0 round of that one-core baseline factors
    two saddle systems, 68-100 s a round, three rounds). Its
    scipy_qoi_oracle takes the result of start_unstructured_oracle (`ahead`)
    when the twin's (A, b, obs) equal that one's bit for bit, and solves in
    line otherwise. Then 22h: K2 at each level's draw (nothing of this path
    calls K1)."""
    import numpy as np
    import torch

    from parelagmc_tpu_torch.examples import unstructured_performance as up
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    mesh, future = ahead
    seen = {}

    def oracle(hier, solver, level, w):
        A, b, obs = up.oracle_system(hier, solver, level, w)
        t0 = time.perf_counter()
        (A0, b0, obs0), q, lu_s = future.result()
        seen.update(wait_s=time.perf_counter() - t0, lu_s=lu_s)
        seen["same"] = (level == 0 and A.shape == A0.shape and (A != A0).nnz == 0
                        and np.array_equal(b, b0) and np.array_equal(obs, obs0))
        return q if seen["same"] else up.oracle_solve(A, b, obs)

    with replaced(up, "scipy_qoi_oracle", oracle), replaced(
            up, "scipy_pair_baseline", lambda hier, solver, level, nmeas=3: float("nan")):
        ev, _, _, launches, _ = evidence_run(
            "unstructured_performance",
            ["--mesh", mesh, "--out", os.path.join(tmp, "u.json")] + EVIDENCE_UNSTRUCTURED_ARGV,
            tmp, record=False)
    print(f"22c QoI oracle: its sparse LU took {seen['lu_s']:.1f} s in a thread from the start "
          f"of phase 22; the twin waited {seen['wait_s']:.1f} s for it; the twin's system equal "
          f"to the thread's: {seen['same']}" + ("" if seen["same"] else " (solved in line)"),
          flush=True)
    oracle = ev["qoi_oracle"]
    print(f"22c unstructured_performance: cells {ev['cells']} faces {ev['faces']}, host setup "
          f"{ev['setup_sec']}, QoI oracle device {oracle['q_device']!r} scipy "
          f"{oracle['q_scipy']!r} rel {oracle['rel_err']:.3e} [{ev['device']}]", flush=True)
    if not oracle["rel_err"] <= EVIDENCE_ORACLE_RTOL:
        fail(f"22c: QoI oracle {oracle}")
    tpu = tpu_record("UNSTRUCTURED_EVIDENCE.json")
    for row in ev["levels"]:
        pair = row["pair"]
        if pair["converged_fraction"] != 1.0:
            fail(f"22c level {row['level']}: {pair}")
        line = (f"22c unstructured_performance level {row['level']} ({row['darcy_dofs']} dofs): "
                f"[{ev['device']}] {ms_text(pair['sec_per_sample'])} ms/sample, iterations "
                f"{pair['mean_iterations']:.2f}, converged 1.0 (scipy baseline not run here)")
        if tpu is not None:
            t = tpu["levels"][row["level"]]
            line += (f"; [TPU v5e, JAX package, UNSTRUCTURED_EVIDENCE.json, cube_tet.mesh] "
                     f"{ms_text(t['pair']['sec_per_sample'])} ms/sample, iterations "
                     f"{t['pair']['mean_iterations']:.2f}")
        print(line, flush=True)
    print(f"22c per-iteration cost at level 0: {ev['profile_level0']} [{ev['device']}]",
          flush=True)
    key = fold_in(PRNGKey(0), 97)
    k2 = None
    for level, cells in enumerate(ev["cells"]):
        shape = (ev["batch"], cells)
        _, r = k2_check(fold_in(key, level), shape, torch.float32, torch.device("cuda", 0),
                        F32_TOL_K2, f"evidence unstructured level {level}",
                        EVIDENCE_PLAIN_REPS, EVIDENCE_GRAPH_REPLAYS)
        print(k2_line(f"evidence unstructured level {level} float32: K2 noise {shape}", r,
                      F32_TOL_K2, gpu), flush=True)
        if k2 is None:
            k2 = dict(r, max_abs_err=r["abs_err"])
        else:
            k2["max_abs_err"] = max(k2["max_abs_err"], r["abs_err"])
    return "unstructured_performance", launches, {"unstructured_f32": {"threefry_normal": k2}}


def phase_evidence_adjoint(gpu: str, tmp: str):
    """Phase 22d: spe10_adjoint_check on the command line that
    SPE10_ADJOINT_EVIDENCE.json records (full grid, batch 8, seed 7, plain
    and truth at rtol 1e-6, adjoint at 1e-4): every leg converged, finite
    Y; errors and iterations beside the recorded TPU ones. Then 22h."""
    out_json = os.path.join(tmp, "adjoint.json")
    _, _, _, launches, built = evidence_run(
        "spe10_adjoint_check", EVIDENCE_ADJOINT_ARGV + ["--out", out_json], tmp)
    with open(out_json) as fh:
        ev = json.load(fh)
    tpu = tpu_record("SPE10_ADJOINT_EVIDENCE.json")
    if not math.isfinite(ev["truth"]["E_Y"]):
        fail(f"22d: E_Y {ev['truth']}")
    for leg in ("truth", "plain", "adjoint"):
        r = ev[leg]
        if r["converged"] is not True:
            fail(f"22d {leg}: {r}")
        errs = ("" if leg == "truth" else
                f"max rel Y error {r['max_rel_Y_error']:.4g}, Q error {r['max_rel_Q_error']:.4g}, ")
        if leg != "truth" and not (math.isfinite(r["max_rel_Y_error"])
                                   and math.isfinite(r["max_rel_Q_error"])):
            fail(f"22d {leg}: {r}")
        line = (f"22d spe10_adjoint_check {leg}: [{ev['device']}] {errs}iterations "
                f"{r['iterations']}, {ms_text(r['sec_per_sample'])} ms/sample, converged")
        if tpu is not None:
            t = tpu[leg]
            line += (f"; [TPU v5e, JAX package, SPE10_ADJOINT_EVIDENCE.json] "
                     + ("" if leg == "truth" else
                        f"Y error {t['max_rel_Y_error']:.4g}, Q error {t['max_rel_Q_error']:.4g}, ")
                     + f"iterations {t['iterations']}, {ms_text(t['sec_per_sample'])} ms/sample")
        print(line, flush=True)
    print(f"22d E[Y] truth {ev['truth']['E_Y']!r} [{ev['device']}]", flush=True)
    adjoint_f64_witness(built[0], ev["config"], gpu)
    checks = {"spe10_adjoint_f32": evidence_checks("spe10_adjoint_check", built[0], [8, 8], gpu)}
    return "spe10_adjoint_check", launches, checks


def adjoint_f64_witness(p0, config: dict, gpu: str):
    """22d's truth leg again in float64 on the card, on the twin's float32
    fields (its sample_fields of the truth problem `p0`), beside the same
    float32 pair on the same fields: E[Y] of each, how far the float32
    truth's Y and Q lie from the float64 one's. The float64 pair must
    converge with finite QoIs."""
    import numpy as np
    import torch

    from parelagmc_tpu_torch.examples import spe10_adjoint_check as adj

    batch, seed, rtol = config["batch"], config["seed"], config["rtols"]["truth"]
    s_f, s_c = adj.sample_fields(p0, seed, batch)
    q32, qc32, it32, _, _, conv32 = adj.pair_once(p0.solver, s_f, s_c, True)
    p64 = adj.build(tuple(config["grid"]), batch, seed, True, rtol, "float64", p0.solver.device)
    q64, qc64, it64, segs64, dt64, conv64 = adj.pair_once(
        p64.solver, s_f.to(torch.float64), s_c.to(torch.float64), True)
    y32, y64 = q32 - qc32, q64 - qc64
    if not conv64 or not (np.isfinite(q64).all() and np.isfinite(qc64).all()):
        fail(f"22d float64 truth: converged {conv64}, Q {q64}, Qc {qc64}")
    print(f"22d truth witness (adjoint at rtol {rtol:g}, the twin's float32 fields): E[Y] float64 "
          f"{float(np.mean(y64))!r} ({it64} iterations, {segs64} fine segments, {dt64:.2f} s), "
          f"float32 {float(np.mean(y32))!r} ({it32} iterations, converged {conv32}); float32 "
          f"against float64: max |dY| {float(np.max(np.abs(y32 - y64))):.4g} (max |Y| "
          f"{float(np.max(np.abs(y64))):.4g}), max rel Q {float(np.max(np.abs(q32 - q64) / np.abs(q64))):.3e}, "
          f"max rel Qc {float(np.max(np.abs(qc32 - qc64) / np.abs(qc64))):.3e}; Y float64 "
          f"{np.array2string(y64, precision=5)} float32 {np.array2string(y32, precision=5)}; Q "
          f"float64 {np.array2string(q64, precision=6)} [{gpu}]", flush=True)
    del p64
    torch.cuda.empty_cache()


def phase_evidence_beta(gpu: str, tmp: str):
    """Phase 22e: spe10_beta_noise --samples EVIDENCE_BETA_SAMPLES on the
    full grid (both legs through the spe10_mlmc twin): the prod leg's Y
    finite on every level; noise fraction, correlation and mean iterations
    per leg, a deep-leg level at or above one solve's budget marked. Then
    22h at the prod leg's shapes."""
    ev, _, _, launches, built = evidence_run(
        "spe10_beta_noise", ["--samples", str(EVIDENCE_BETA_SAMPLES)], tmp, record="spe10_mlmc")
    prob = built[0]
    budget = int(prob.solver.solver_cfg.max_iterations) * max(
        1, int(getattr(prob.config, "solve_segments", 1)))
    for lv in ev["levels"]:
        if not (math.isfinite(lv["mean_Y_prod"]) and math.isfinite(lv["var_Y_prod"])):
            fail(f"22e level {lv['level']}: {lv}")
        flag = (f" DEEP LEG AT OR ABOVE ONE SOLVE'S BUDGET ({budget}): unconverged noise, not a "
                f"variance" if lv["mean_iters_deep"] >= budget else "")
        print(f"22e spe10_beta_noise level {lv['level']} (n {lv['n']}): Var[Y] prod "
              f"{lv['var_Y_prod']:.6g} deep {lv['var_Y_deep']:.6g}, noise fraction "
              f"{lv['noise_fraction_of_var']:.4g}, corr {lv['corr']:.6f}, mean iterations prod "
              f"{lv['mean_iters_prod']:.2f} deep {lv['mean_iters_deep']:.2f}{flag} "
              f"[{ev['device']}]", flush=True)
    if "beta_prod" in ev:
        print(f"22e beta prod {ev['beta_prod']:.4f} deep {ev['beta_deep']:.4f} "
              f"({EVIDENCE_BETA_SAMPLES} samples a level; SPE10_BETA_NOISE.json: 256, TPU v5e)",
              flush=True)
    batches = list(prob.config.batch_size_per_level or [prob.config.batch_size] * len(ev["levels"]))
    checks = {"spe10_beta_noise_f32": evidence_checks("spe10_beta_noise", prob, batches, gpu)}
    return "spe10_beta_noise", launches, checks


def phase_evidence_mg_tuning(gpu: str, tmp: str):
    """Phase 22f: spe10_mg_tuning at its defaults (30x110x42, float64, batch
    4, fourteen variants, rtol 1e-5): every row converges; the measured
    t_schur, t_ovh, t_apply; the rows. At rtol 1e-5 the flux QoI is only as
    sharp as the tolerance leaves it at this contrast (the driver's own
    warning fires), so the converged rows' Q[0] are held to
    EVIDENCE_MG_Q0_RTOL on a second run, --quick, at EVIDENCE_MG_DEEP_RTOL.
    Then 22h."""
    rows, out, _, launches, built = evidence_run(
        "spe10_mg_tuning", ["--json", os.path.join(tmp, "mg.json")], tmp)
    print(f"22f spe10_mg_tuning components: t_schur {rows[0]['t_schur']:.4f} ms, t_ovh "
          f"{rows[0]['t_ovh']:.4f} ms, t_apply {rows[0]['t_apply']:.4f} ms (30x110x42, batch 4, "
          f"float64) [{gpu}]", flush=True)

    def show(tag, rows_):
        qs = [r["q0"] for r in rows_ if r["converged"]]
        for r in rows_:
            print(f"22f {tag} {r['label']:22s} iterations {r['iters']:4d} converged "
                  f"{r['converged']} S/cycle {r['s_applies']} est {r['est_ms']:.1f} ms, "
                  f"measured {r['cpu_s']:.3f} s, Q[0] {r['q0']!r}", flush=True)
        spread = (max(qs) - min(qs)) / max(abs(q) for q in qs)
        print(f"22f {tag}: Q[0] spread over {len(qs)} converged rows {spread:.3e}; "
              + next((l for l in out.splitlines() if l.startswith("# best")), ""), flush=True)
        return spread

    show("rtol 1e-5", rows)
    if len(rows) != 14 or not all(r["converged"] for r in rows):
        fail(f"22f: rows {[(r['label'], r['converged']) for r in rows]}")
    deep, out, _, deep_launches, _ = evidence_run(
        "spe10_mg_tuning", ["--rtol", f"{EVIDENCE_MG_DEEP_RTOL:g}", "--quick"], tmp,
        record=False)
    spread = show(f"rtol {EVIDENCE_MG_DEEP_RTOL:g}", deep)
    if not all(r["converged"] for r in deep) or not spread <= EVIDENCE_MG_Q0_RTOL:
        fail(f"22f: at rtol {EVIDENCE_MG_DEEP_RTOL:g} converged rows' Q[0] spread {spread}")
    launches = {k: launches[k] + deep_launches[k] for k in launches}
    checks = {"spe10_mg_tuning_f64": evidence_checks("spe10_mg_tuning", built[0], [4], gpu)}
    return "spe10_mg_tuning", launches, checks


def phase_evidence_rate(gpu: str, tmp: str):
    """Phase 22g: spe10_rate_diagnostics at its defaults (16x56x16, n 64, 3
    levels, float64, cuda:0): every solve converged (read from each solve's
    info). Then 22h."""
    converged = []

    def watch(prob):
        real = prob.solver.solve_fwd

        def solve_fwd(*args, **kw):
            out = real(*args, **kw)
            converged.append(bool(out[2].converged.all()))
            return out

        prob.solver.solve_fwd = solve_fwd

    _, out, _, launches, built = evidence_run("spe10_rate_diagnostics", [], tmp, on_build=watch)
    print("\n".join(f"22g {line}" for line in out.splitlines()), flush=True)
    if len(converged) != 2 * 4 * 3 or not all(converged):
        fail(f"22g: converged {converged}")
    prob = built[0]
    del prob.solver.solve_fwd
    checks = {"spe10_rate_diagnostics_f64": evidence_checks(
        "spe10_rate_diagnostics", prob, [16] * prob.config.nlevels, gpu)}
    return "spe10_rate_diagnostics", launches, checks


# In the order they run: 22c last, so that its oracle's LU, begun at the
# start of phase 22, is done by then.
EVIDENCE_PHASES = (("22a spe10_performance", phase_evidence_performance),
                   ("22b spe10_sampler_performance", phase_evidence_sampler),
                   ("22d spe10_adjoint_check", phase_evidence_adjoint),
                   ("22e spe10_beta_noise", phase_evidence_beta),
                   ("22f spe10_mg_tuning", phase_evidence_mg_tuning),
                   ("22g spe10_rate_diagnostics", phase_evidence_rate),
                   ("22c unstructured_performance", phase_evidence_unstructured))


def phase_graft_entry(gpu: str):
    """Phase 23: the graft twin (parelagmc_tpu_torch.graft_entry) on cuda:0:
    entry() and one forward step, then dryrun_multichip(GRAFT_DEVICES), each
    with the launch counts set to 0 just before it (its own checks raise);
    then K1 and K2 against their plain versions at each distinct shape they
    launch: the entry step's draw (8, 512) and M(w)^-1 at 8^3 and 4^3, batch
    8; the dry run's MLMC on the 2-level 2^3 box, one shard (batch 2) and
    unsharded (batch 16), every level's draw and M(w)^-1; its unsharded
    spatial M(w)^-1 and the sharded M(w)^-1's slab layouts (spatial_k1_checks),
    all float32. Returns ({path: launches}, {check: results}, {layout:
    results})."""
    import types

    import torch

    from parelagmc_tpu_torch import graft_entry, kernels
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in

    launches = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    y, q = fn(*args)
    torch.cuda.synchronize()
    dt_entry = time.perf_counter() - t0
    launches["forward_step"] = dict(kernels.launch_counts)
    if not (tuple(q.shape) == tuple(y.shape) == (8,) and bool(torch.isfinite(q).all())
            and bool(torch.isfinite(y).all())):
        fail(f"graft entry: forward step gave {q} {y}")
    print(f"graft entry: entry() + one forward step {dt_entry:.2f} s, output shapes "
          f"{[tuple(o.shape) for o in (y, q)]}, E[q] {q.double().mean().item():.6f}, launches "
          f"{launches['forward_step']} [{gpu}]", flush=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        r = graft_entry.dryrun_multichip(GRAFT_DEVICES)
    except AssertionError as e:
        fail(f"graft dryrun_multichip({GRAFT_DEVICES}): a check failed: {e}")
    torch.cuda.synchronize()
    dt_dry = time.perf_counter() - t0
    launches["dryrun_multichip"] = dict(kernels.launch_counts)
    print(f"graft dryrun_multichip({GRAFT_DEVICES}) ok in {dt_dry:.2f} s: eQ sharded "
          f"{r['eQ'].tolist()} unsharded {r['eQ_ref'].tolist()} (6 se {(6 * r['se']).tolist()}) "
          f"split {r['eQ_split'].tolist()}; spatial (dp, sp) = (2, {GRAFT_DEVICES // 2}) max rel Q "
          f"{float(abs(r['q_sp'] / r['q_ref'] - 1).max()):.3e} cold (residual "
          f"{r['residual']:.3e}), {float(abs(r['q_warm'] / r['q_ref'] - 1).max()):.3e} warm in "
          f"{r['warm_iterations']} iterations; launches {launches['dryrun_multichip']} [{gpu}]",
          flush=True)
    for path, n in launches.items():
        for k in ("thomas", "threefry_normal"):
            if n[k] <= 0:
                fail(f"kernel {k} was not launched by the graft twin's {path}")

    checks = {}
    key = fold_in(PRNGKey(23), 0)
    _, sampler, solver, _ = graft_entry.build(nlevels=2, base_cells=(4, 4, 4), batch=8)
    entry_checks = path_kernel_checks(types.SimpleNamespace(sampler=sampler, solver=solver), [8],
                                      key, F32_TOL_K1, F32_TOL_K2, "graft entry", gpu)
    _, err = level_k1_check(sampler, solver, 1, key, 8, F32_TOL_K1, "graft entry level 1",
                            "float32", gpu)
    entry_checks["thomas"]["max_abs_err"] = max(entry_checks["thomas"]["max_abs_err"], err)
    checks["entry_batch8"] = entry_checks
    batch = 2 * GRAFT_DEVICES
    _, sampler, solver, _ = graft_entry.build(nlevels=2, base_cells=(2, 2, 2), batch=batch)
    prob = types.SimpleNamespace(sampler=sampler, solver=solver)
    for tag, b in (("dryrun_shard_batch2", batch // GRAFT_DEVICES),
                   ("dryrun_unsharded_batch16", batch)):
        checks[tag] = path_kernel_checks(prob, [b, b], key, F32_TOL_K1, F32_TOL_K2,
                                         f"graft {tag}", gpu)
    dsolver, ssolver, w = graft_entry.spatial_problem(GRAFT_DEVICES)
    ms_ = dsolver.levels[0].mass_solver
    fac = ms_.factor(w)
    k1 = k1_check(ms_, fac, random_rhs(fac, 23), F32_TOL_K1, "graft spatial unsharded")
    print(k1_line(f"graft dryrun spatial unsharded batch {w.shape[0]} float32: K1 M(w)^-1 "
                  f"{ms_.shape} cells", k1, F32_TOL_K1, gpu), flush=True)
    checks["dryrun_spatial_unsharded_batch4"] = {"thomas": dict(k1, max_abs_err=k1["abs_err"])}
    sd = ssolver._spatial(0)
    layouts = spatial_k1_checks(sd, w, F32_TOL_K1, f"graft dryrun sharded M(w)^-1 (5, "
                                f"{2 * GRAFT_DEVICES}, 4) sp {sd.n_sp} dp {sd.n_dp} batch "
                                f"{w.shape[0]} float32", gpu)
    torch.cuda.empty_cache()
    return launches, checks, layouts


def shared_build(real):
    """build_problem memoized over what a build depends on: a config that
    differs from one built before only in batch_size and in the Darcy
    settings read at solve time (tolerance, iteration budget, preconditioner
    state dtype) gets that problem, with its own config and a shallow copy
    of its solver that carries its own settings (phase 24's four level-0
    probes share one build of their grid this way)."""
    import copy
    import dataclasses

    cache = {}

    def build(cfg, kinv_ref=None, device=None):
        ds = cfg.darcy_solver
        key = (repr(dataclasses.replace(cfg, batch_size=0, darcy_solver=dataclasses.replace(
            ds, relative_tolerance=0.0, max_iterations=0, coefmg_prec_dtype=""))), str(device))
        if key not in cache:
            cache[key] = real(cfg, kinv_ref=kinv_ref, device=device)
        prob = cache[key]
        solver = copy.copy(prob.solver)
        solver.config, solver.solver_cfg = cfg, ds
        return prob._replace(config=cfg, solver=solver)

    return build


def all_finite(x) -> bool:
    """Every number in a nested dict or list is finite."""
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(all_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def probe_run(name: str, argv, tmp: str, gpu: str, build=None):
    """A phase-24 probe through evidence_run (its build_problem replaced by
    `build` where given): (result, launches, recorded problem); it fails on
    a non-finite number."""
    import importlib

    module = importlib.import_module(f"parelagmc_tpu_torch.examples.{name}")
    with (replaced(module, "build_problem", build) if build is not None
          else contextlib.nullcontext()):
        res, out, wall, launches, built = evidence_run(
            name, argv, tmp, record=None if hasattr(module, "build_problem") else False)
    if not all_finite(res) or res["device"] != gpu:
        fail(f"24 {name}: {res}\n{out[-3000:]}")
    return res, launches, (built[0] if built else None)


def marginal_text(r: dict) -> str:
    return f"{r['ms']:.4f} (wall {r['wall_ms']:.4f})"


def phase_probes(gpu: str):
    """Phase 24: the six SPE10 layer probes (parelagmc_tpu_torch/examples/
    spe10_{level0_breakdown,struct_profile,vcycle_profile,iter_cost,
    level1_cost,layout_probe}), each through main(argv) at its defaults on
    cuda:0, the launch counts set to 0 just before each, the four level-0
    probes on one shared build of the full grid (shared_build); every
    number finite; iter_cost's budgets run exactly lo and hi iterations;
    level1_cost's batches end converged 1.0. One line per probe (the JAX
    probes wrote no file, so no TPU figure stands beside them). Then K1 and
    K2 against their plain versions at each distinct shape the probes give
    them: level 0 at batch 8 (K2's (8, 1 122 000) draw) and 16 (unpermuted
    60x220x85 grid), levels 1 and 2 at batch 128 of the auto-ordered grid
    (K2 at level 1)."""
    import tempfile

    import torch

    from parelagmc_tpu_torch import problems

    runs, checks = {}, {}
    build = shared_build(problems.build_problem)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_probes_") as tmp:
        bd, runs["spe10_level0_breakdown"], prob = probe_run(
            "spe10_level0_breakdown", [], tmp, gpu, build)
        print(f"24a spe10_level0_breakdown (60x220x85, batch 8, float32) [{bd['device']}]: "
              + ", ".join(f"{k} {bd[k]['ms']:.4f} ms (wall {bd[k]['wall_ms']:.4f})"
                          for k in ("Minv", "apply_S", "v_cycle+setup", "pcg_10"))
              + f"; per iteration pcg {bd['per_iteration']['pcg_ms']:.4f} ms (wall "
              f"{bd['per_iteration']['pcg_wall_ms']:.4f})", flush=True)
        checks["probes_spe10_level0_breakdown_f32"] = evidence_checks(
            "spe10_level0_breakdown", prob, [8], gpu)
        probs = {}
        for tag, name in (("24b", "spe10_struct_profile"), ("24c", "spe10_vcycle_profile")):
            res, runs[name], probs[name] = probe_run(name, [], tmp, gpu, build)
            print(f"{tag} {name} (60x220x85, batch 16, float32, chain marginals K {res['K']}, "
                  f"ms by events (wall)) [{res['device']}]: "
                  + ", ".join(f"{k} {marginal_text(v)}" for k, v in res.items()
                              if isinstance(v, dict)), flush=True)
        ic, runs["spe10_iter_cost"], _ = probe_run("spe10_iter_cost", [], tmp, gpu, build)
        its = {b: r["iterations"] for b, r in ic["budgets"].items()}
        if its != {ic["lo"]: ic["lo"], ic["hi"]: ic["hi"]}:
            fail(f"24d spe10_iter_cost: iterations {its} at budgets {ic['lo']}/{ic['hi']}")
        print(f"24d spe10_iter_cost (60x220x85, batch 16, float32, rtol 0) [{ic['device']}]: "
              + ", ".join(f"{b} iterations {r['ms']:.3f} ms (wall {r['wall_ms']:.3f})"
                          for b, r in ic["budgets"].items())
              + f"; per iteration {ic['per_iteration_ms']:.4f} ms (wall "
              f"{ic['per_iteration_wall_ms']:.4f}), per sample and iteration "
              f"{ic['per_sample_iteration_ms']:.5f} ms (wall "
              f"{ic['per_sample_iteration_wall_ms']:.5f})", flush=True)
        # struct_profile and iter_cost give K1 the same shape: level 0, batch 16.
        checks["probes_spe10_struct_profile_iter_cost_f32"] = evidence_checks(
            "spe10_struct_profile/iter_cost", probs["spe10_struct_profile"], [16], gpu, draws=())
        del prob, probs, build
        torch.cuda.empty_cache()
        l1, runs["spe10_level1_cost"], prob = probe_run("spe10_level1_cost", [], tmp, gpu)
        for b, row in enumerate(l1["batches"]):
            print(f"24e spe10_level1_cost batch {b} (level {l1['level']} pair, batch "
                  f"{l1['batch']}, segments {l1['segments']} x {l1['max_iterations']}) "
                  f"[{l1['device']}]: "
                  + " | ".join(f"{st['stage']} {st['wall_s']:.3f} s it={st['iterations']} "
                               f"conv={st['converged']:.2f}" for st in row["stages"])
                  + f"; total {row['ms_per_sample']:.3f} ms/sample, E[Y] {row['E_Y']!r}",
                  flush=True)
        for row in l1["batches"]:
            coarse = [st for st in row["stages"] if st["stage"] in ("stage1", "cont_c")][-1]
            if coarse["converged"] != 1.0 or row["converged"] != 1.0:
                fail(f"24e spe10_level1_cost: not converged 1.0: {row}")
        print(f"24e spe10_level1_cost: mean {l1['mean_ms_per_sample']:.3f} ms/sample, mean "
              f"iterations a batch {l1['mean_iterations']:.1f} [{l1['device']}]", flush=True)
        checks["probes_spe10_level1_cost_f32"] = evidence_checks(
            "spe10_level1_cost", prob, [l1["batch"]] * 2, gpu, levels=[1, 2], draws=(1,))
        del prob
        torch.cuda.empty_cache()
        lp, runs["spe10_layout_probe"], _ = probe_run("spe10_layout_probe", [], tmp, gpu)
        base = tuple(lp["orders"][0]["order"])
        for row in lp["orders"]:
            print(f"24f spe10_layout_probe order {tuple(row['order'])} (batch {lp['batch']}, "
                  f"float32) [{lp['device']}]: s_apply {marginal_text(row['s_apply'])} ms, "
                  f"v_cycle(2,2) {marginal_text(row['v_cycle'])} ms; speed-up against "
                  f"{base}: s_apply {row['s_apply_speedup']:.3f}x, v_cycle "
                  f"{row['v_cycle_speedup']:.3f}x", flush=True)
    torch.cuda.empty_cache()
    print(f"probes: launches {runs} [{gpu}]", flush=True)
    return runs, checks


def _children(pid: int):
    """The pids whose parent is `pid` (torchrun detaches its workers from
    the agent's process group: killing the agent alone would leave them)."""
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(entry))
            except (OSError, IndexError, ValueError):
                pass
    return kids


def torchrun(args, cwd: str, label: str, nproc: int) -> float:
    """`python -m torch.distributed.run --standalone --nproc-per-node
    nproc args` in `cwd`, this checkout first on the ranks' path; rank 0's
    output printed under `label`. A non-zero exit fails the phase; past
    TORCHRUN_DEADLINE the agent and its workers are killed and the phase
    fails. Returns the launch's wall seconds."""
    import signal

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")])}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=TORCHRUN_DEADLINE)
    except subprocess.TimeoutExpired:
        for pid in [*_children(proc.pid), proc.pid]:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        out, err = proc.communicate()
        print(err[-6000:], file=sys.stderr, flush=True)
        fail(f"{label}: torchrun killed past its deadline of {TORCHRUN_DEADLINE} s")
    for line in out.splitlines():
        print(f"  [{label}] {line}", flush=True)
    if proc.returncode != 0:
        print(err[-6000:], file=sys.stderr, flush=True)
        fail(f"{label}: torchrun exited {proc.returncode}")
    return time.perf_counter() - t0


def rank_results(cwd: str, kind: str, n: int) -> list:
    """The per-rank JSON results a phase-25 launch wrote."""
    out = []
    for r in range(n):
        with open(os.path.join(cwd, f"{kind}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def child_golden(argv) -> dict:
    """A rank of 25a: the golden mlmc driver's main(argv) with the launch
    counts set to 0 just before it, then a fixed-count run
    (init_run(TORCHRUN_FIXED)) on the driver's problem and config (no log:
    the driver's MLMC.dat stays as it wrote it)."""
    import dataclasses

    from parelagmc_tpu_torch import kernels
    from parelagmc_tpu_torch.examples import mlmc
    from parelagmc_tpu_torch.parallel.launch import is_main, world_size
    from parelagmc_tpu_torch.uq import MLMCManager

    managers = []

    class Recorded(MLMCManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            managers.append(self)

    mlmc.MLMCManager = Recorded
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est = mlmc.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    mgr = managers[0]
    fixed = MLMCManager(mgr.solver, mgr.sampler,
                        dataclasses.replace(mgr.config, output_filename=""))
    fixed.init_run(TORCHRUN_FIXED)
    if is_main():
        print(f"rank 0 of {world_size()}: mlmc.main {wall:.2f} s (build and run), estimate "
              f"{est:.6f} N_l {mgr.level_nsamples.tolist()}, launches K1 {launches['thomas']} "
              f"K2 {launches['threefry_normal']}", flush=True)
    return dict(estimate=est, nsamples=mgr.level_nsamples.tolist(), cost=mgr.cost.tolist(),
                launches=launches, wall=wall, world=world_size(),
                shards=mgr.sharding.n_devices, distributed=mgr.sharding.distributed,
                dofs=mgr.M.tolist(), device=str(mgr.solver.device),
                fixed_sums=fixed.sums.tolist(), fixed_nsamples=fixed.level_nsamples.tolist())


def child_graft(device: str) -> dict:
    """A rank of 25b: the graft twin's main on `device` (entry() and
    dryrun_multichip(world)), the launch counts set to 0 just before it."""
    from parelagmc_tpu_torch import graft_entry, kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = graft_entry.main(["--device", device])
    return dict(wall=time.perf_counter() - t0, launches=dict(kernels.launch_counts),
                sample_mesh=r["sample_mesh"], slabs=r["slabs"], eQ=r["eQ"].tolist(),
                residual=r["residual"], warm_iterations=r["warm_iterations"])


def spatial_full_step(argv):
    """25c's full-grid problem (spe10_mlmc.build_config(argv): phase 9's
    config with argv's --spatial-shards and --device) and one level-0 pair
    step at TORCHRUN_SPATIAL_BATCH on a fixed key, its first call made
    (SpatialDarcy built, warmed up). Returns (problem, step)."""
    import torch

    from parelagmc_tpu_torch.examples import spe10_mlmc
    from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
    from parelagmc_tpu_torch.problems import build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg, device, kinv, _ = spe10_mlmc.build_config(argv)
    prob = build_problem(cfg, kinv_ref=kinv, device=device)
    budget = MLMCManager(prob.solver, prob.sampler, cfg).pair_budget
    step = level_step(prob.solver, prob.sampler, 0, fold_in(PRNGKey(cfg.seed), 125),
                      TORCHRUN_SPATIAL_BATCH, budget)
    step()
    torch.cuda.synchronize()
    return prob, step


def measured_step(step, device) -> dict:
    """One call of a level-0 pair step: Q, iterations, converged fraction,
    wall ms, peak memory of `device` in GB and K1's launches."""
    import torch

    from parelagmc_tpu_torch import kernels

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    q, infos = step()
    torch.cuda.synchronize()
    return dict(q=q.double().cpu().tolist(), its=[int(i.iterations) for i in infos],
                conv=float(torch.cat([i.converged.float() for i in infos]).mean()),
                ms=1e3 * (time.perf_counter() - t0),
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                launches=kernels.launch_counts["thomas"])


def child_spatial(argv) -> dict:
    """A rank of 25c: the full-grid level-0 pair step, a slab a rank
    (DistributedSlabs through slab_comm)."""
    import torch

    prob, step = spatial_full_step(argv)
    device = prob.solver.device
    r = measured_step(step, device)
    r["slabs"] = type(prob.solver._spatial(0).comm).__name__
    r["device"] = str(device)
    del prob, step
    torch.cuda.empty_cache()
    return r


def child_main(argv) -> dict:
    """A rank of 25a and then 25b, on the rank's device: they share one
    launch, since each launch pays ~20 s of process start and CUDA and NCCL
    initialization (25c has its own)."""
    golden = child_golden(argv)
    return {"golden": golden, "graft": child_graft(golden["device"])}


TORCHRUN_CHILDREN = {"main": child_main, "spatial": child_spatial}


def torchrun_child(kind: str, out_dir: str, argv) -> None:
    """One rank of a phase-25 launch (`chip_smoke.py --torchrun-child KIND
    OUT_DIR [ARGV]` under torchrun): TORCHRUN_CHILDREN[KIND](ARGV), its
    result written to OUT_DIR/KIND_rank<r>.json. Nothing is caught: a
    failure exits the rank non-zero, and torchrun with it."""
    sys.path.insert(0, HERE)
    import torch.distributed as dist

    from parelagmc_tpu_torch import kernels

    kernels.library()
    result = TORCHRUN_CHILDREN[kind](argv)
    with open(os.path.join(out_dir, f"{kind}_rank{dist.get_rank()}.json"), "w") as f:
        json.dump(result, f)


def phase_torchrun(device, gpu: str, stacked_peak_gb: float):
    """Phase 25: the port under torchrun on every card of the host (N =
    torch.cuda.device_count(), NCCL, a rank a card). 25a: the golden mlmc
    driver (--sample-shards -1, walltime cost): the estimate, equal N_l on
    every rank, K1 and K2 launched, the log written once; its fixed-count
    sums against the in-process SampleMesh(N) run's; K1 and K2 against
    their plain versions at one shard's batch. 25b: the graft twin,
    dryrun_multichip(N) in the distributed forms. 25c (N >= 2): the
    full-grid level-0 pair step a slab a rank against the stacked form,
    peak memory per card beside `stacked_peak_gb` (phase 21c's). Returns
    ({path: launches of rank 0}, {check: results})."""
    import tempfile
    import types

    import numpy as np
    import torch

    from parelagmc_tpu_torch import graft_entry
    from parelagmc_tpu_torch.examples.common import parse_args
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.problems import build_problem
    from parelagmc_tpu_torch.uq import MLMCManager

    n = torch.cuda.device_count()
    child = [os.path.join(HERE, "chip_smoke.py"), "--torchrun-child"]
    launches, checks = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_torchrun_") as tmp:
        dt = torchrun([*child, "main", tmp, *TORCHRUN_GOLDEN_ARGV], tmp, "25a-b", n)
        results = rank_results(tmp, "main", n)
        ranks = [r["golden"] for r in results]
        r0 = ranks[0]
        with open(os.path.join(tmp, "MLMC.dat")) as f:
            log_lines = sum(1 for _ in f) - 1
        print(f"25a torchrun golden mlmc on {n} rank(s), NCCL: launch (25a and 25b) {dt:.2f} s, "
              f"driver {r0['wall']:.2f} s on rank 0, estimate {r0['estimate']:.6f}, N_l per rank "
              f"{[r['nsamples'] for r in ranks]}, C_l rank 0 {r0['cost']}, devices "
              f"{[r['device'] for r in ranks]}, launches per rank K1 "
              f"{[r['launches']['thomas'] for r in ranks]} K2 "
              f"{[r['launches']['threefry_normal'] for r in ranks]}, log {log_lines} lines "
              f"[{gpu}]", flush=True)
        if r0["dofs"] != [17152, 2240, 304]:
            fail(f"25a: golden dofs {r0['dofs']}")
        if any(r["nsamples"] != r0["nsamples"] or r["estimate"] != r0["estimate"]
               or r["cost"] != r0["cost"] for r in ranks):
            fail("25a: the ranks took different decisions")
        if not math.isfinite(r0["estimate"]) or abs(r0["estimate"] - 2.56) >= 0.25:
            fail(f"25a: golden estimate {r0['estimate']} not within 0.25 of 2.56")
        for r in ranks:
            if not (r["distributed"] and r["shards"] == r["world"] == n):
                fail(f"25a: sample mesh {r['shards']} shards, distributed {r['distributed']}, "
                     f"world {r['world']}")
            for k in ("thomas", "threefry_normal"):
                if r["launches"][k] <= 0:
                    fail(f"25a: kernel {k} was not launched by the torchrun golden run")
        if log_lines != sum(r0["nsamples"]):
            fail(f"25a: the log holds {log_lines} samples, the run took {sum(r0['nsamples'])}")
        launches["golden_mlmc"] = r0["launches"]

        cfg, _ = parse_args(TORCHRUN_GOLDEN_ARGV + ["--device", str(device)])
        cfg.output_filename = ""
        prob = build_problem(cfg, device=device)
        local = MLMCManager(prob.solver, prob.sampler, cfg)
        if local.sharding is None or local.sharding.distributed or local.sharding.n_devices != n:
            fail(f"25a: the in-process run has sample mesh {local.sharding}")
        local.init_run(TORCHRUN_FIXED)
        got, want = np.array(r0["fixed_sums"]), local.sums
        if any(r["fixed_sums"] != r0["fixed_sums"] for r in ranks):
            fail("25a: the ranks' fixed-count sums differ")
        same = bool(np.array_equal(got, want))
        nz = want != 0
        rel = float(np.max(np.abs(got - want)[nz] / np.abs(want[nz])))
        print(f"25a fixed counts {TORCHRUN_FIXED} on {n} rank(s) against SampleMesh({n}) in one "
              f"process, same keys: per-level sums "
              f"{'bit for bit' if same else f'max rel diff {rel:.3e}'} (tol "
              f"{TORCHRUN_FIXED_RTOL:g}), N_l {r0['fixed_nsamples']} [{gpu}]", flush=True)
        if r0["fixed_nsamples"] != local.level_nsamples.tolist() or not (
                same or rel <= TORCHRUN_FIXED_RTOL):
            fail(f"25a: fixed-count sums differ from the in-process run by {rel}")
        shard = local.level_batch[0] // n
        checks[f"torchrun_golden_shard_batch{shard}"] = path_kernel_checks(
            prob, [b // n for b in local.level_batch], PRNGKey(25), F32_TOL_K1, F32_TOL_K2,
            f"25a torchrun golden, one rank's shard (batch {shard})", gpu)
        del prob, local

        ranks = [r["graft"] for r in results]
        slabs = "DistributedSlabs" if n >= 2 else None
        print(f"25b torchrun graft_entry (entry(), dryrun_multichip({n})) on {n} rank(s) after "
              f"25a in its launch: main {ranks[0]['wall']:.2f} s on rank 0, sample mesh "
              f"{ranks[0]['sample_mesh']}, spatial slabs {ranks[0]['slabs']} (one slab: the "
              f"dry run's spatial solve is unsharded at N = 1), eQ {ranks[0]['eQ']}, launches "
              f"per rank {[r['launches'] for r in ranks]} [{gpu}]", flush=True)
        for r in ranks:
            if r["sample_mesh"] != "distributed" or r["slabs"] != slabs:
                fail(f"25b: the dry run used {r['sample_mesh']} sample mesh, slabs {r['slabs']}")
            for k in ("thomas", "threefry_normal"):
                if r["launches"][k] <= 0:
                    fail(f"25b: kernel {k} was not launched by the torchrun graft twin")
        launches["graft_entry"] = ranks[0]["launches"]
        batch = 2 * n
        _, sampler, solver, _ = graft_entry.build(nlevels=2, base_cells=(2, 2, 2), batch=batch,
                                                  device=device)
        checks["torchrun_graft_shard_batch2"] = path_kernel_checks(
            types.SimpleNamespace(sampler=sampler, solver=solver), [2, 2], PRNGKey(26),
            F32_TOL_K1, F32_TOL_K2, "25b torchrun graft dry run, one rank's shard (batch 2)", gpu)

        if n < 2:
            print(f"25c full-grid level-0 pair step a slab a rank (DistributedSlabs): not run, "
                  f"torch.cuda.device_count() is {n} and NCCL takes one rank a card; phase 21c's "
                  f"stacked step holds {stacked_peak_gb:.2f} GB on one card [{gpu}]", flush=True)
            return launches, checks
        argv = SPE10_FULL_ARGV + ["--spatial-shards", str(n)]
        dt = torchrun([*child, "spatial", tmp, *argv], tmp, "25c spatial", n)
        ranks = rank_results(tmp, "spatial", n)
    _, step = spatial_full_step(argv + ["--device", str(device)])
    ref = measured_step(step, device)
    del step
    torch.cuda.empty_cache()
    q, q_ref = np.array(ranks[0]["q"]), np.array(ref["q"])
    rel = float(np.max(np.abs(q - q_ref) / np.abs(q_ref)))
    print(f"25c full-grid level-0 pair step batch {TORCHRUN_SPATIAL_BATCH} sp {n} a slab a rank "
          f"(launch {dt:.2f} s): max rel Q diff vs stacked {rel:.3e} (tol {PRODUCTION_Q_RTOL:g}), "
          f"iterations {[r['its'] for r in ranks]} (stacked {ref['its']}), converged "
          f"{[r['conv'] for r in ranks]}, step ms {[round(r['ms'], 1) for r in ranks]}, peak GB "
          f"per card {[round(r['peak_gb'], 3) for r in ranks]} against {ref['peak_gb']:.3f} "
          f"stacked at sp {n} and {stacked_peak_gb:.3f} in phase 21c, K1 launches "
          f"{[r['launches'] for r in ranks]} [{gpu}]", flush=True)
    for r in ranks:
        if r["slabs"] != "DistributedSlabs" or r["conv"] < 1.0 or r["launches"] <= 0:
            fail(f"25c: slabs {r['slabs']}, converged {r['conv']}, K1 launches {r['launches']}")
    if not (np.isfinite(q).all() and rel <= PRODUCTION_Q_RTOL):
        fail(f"25c: the distributed step's Q differs from the stacked one by {rel}")
    launches["spatial_full_grid"] = {"thomas": ranks[0]["launches"]}
    return launches, checks


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

    walls = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its wall seconds kept under `name`."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = round(time.perf_counter() - t0, 2)
        return out

    libs = timed("1 build", kernels.build_library)
    kernels.library()
    print(f"build: {[os.path.relpath(p, HERE) for p in libs]} in {walls['1 build']:.2f} s "
          f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'}); "
          f"SM clocks {sm_clocks_per_s() / 1e12:.3f} T/s [{gpu}]", flush=True)

    timed("2 K1", phase_k1, device, gpu)
    timed("3 K2", phase_k2, device, gpu)
    k3, k3_launches = timed("7 K3", phase_k3, device, gpu)
    golden = timed("4 MLMC", phase_mlmc, device, gpu)
    sharded, sharded_checks = timed("14 sharded golden", phase_sharded_golden, device, gpu)
    bench_launches = timed("5 bench", phase_bench, gpu)
    timed("6 64^3", phase_64, device, gpu)
    anchor, _, _ = timed("8 anchor", phase_spe10_anchor, device, gpu)
    samplers = timed("10 samplers", phase_samplers, device, gpu)
    ratio_anchor, ratio_anchor_estimates = timed("11 ratio anchor", phase_ratio_anchor, device,
                                                 gpu)
    t0 = time.perf_counter()
    spe10 = timed("9 SPE10 setup", spe10_full_problem, device)
    setup_s = time.perf_counter() - t0
    timed("9a K1 lines", phase_k1_lines, spe10, device, gpu)
    full, checks = timed("9b SPE10", phase_spe10_full, spe10, setup_s, device, gpu)
    ratio_full = timed("12 ratio full", phase_ratio_full, spe10, device, gpu)
    full_solvers = timed("13b solvers full", phase_solvers_full, spe10, device, gpu)
    spatial_full, layouts_f32, stacked_peak = timed("21c spatial full grid + 21d f32",
                                                    phase_spatial_full, spe10, device, gpu)
    del spe10
    spatial_full += timed("21c spatial full grid f64", phase_spatial_full_f64, device, gpu)
    static_full, k1_static = timed("13b static MG", phase_static_mg_full, device, gpu)
    scaled_solvers = timed("13a solvers scaled", phase_solvers_scaled, device, gpu)
    timed("13a minres scaled", phase_minres_scaled, device, gpu)
    ratio_cg_schur, _ = timed("13a ratio cg-schur", phase_ratio_anchor, device, gpu,
                              solver="cg-schur", rtol=RATIO_ANCHOR_CG_SCHUR_RTOL)
    minres_box = timed("13b minres box", phase_minres_box, device, gpu)
    agglomerated, k2_agglomerated, ctx = timed("15 unstructured agglomerated",
                                               phase_unstructured_agglomerated, device, gpu)
    hybrid_agglomerated = timed("17 hybrid agglomerated", phase_hybrid_agglomerated, ctx, device,
                                gpu)
    nested, k2_nested, ctx = timed("16 unstructured nested", phase_unstructured_nested, device,
                                   gpu)
    hybrid_nested = timed("18 hybrid nested", phase_hybrid_nested, ctx, device, gpu)
    del ctx
    mesh_files, k2_mesh_files = timed("19 mesh files", phase_mesh_files, device, gpu)
    drivers, driver_checks = timed("20 drivers", phase_drivers, gpu, ratio_anchor_estimates)
    spatial_golden = timed("21a spatial golden", phase_spatial_golden, device, gpu)
    spatial_anchor, _, anchor_prob = timed("21b spatial anchor", phase_spe10_anchor, device, gpu,
                                           spatial_shards=SPATIAL_ANCHOR_SHARDS)
    layouts_f64 = timed("21d f64", phase_spatial_anchor_layouts, anchor_prob, gpu)
    del anchor_prob
    timed("21e spatial_scaling", phase_spatial_scaling, gpu)
    # Phase 22: the seven evidence and tuning drivers, each in process on
    # cuda:0 in a temporary working directory, then 22h at its shapes.
    import tempfile

    evidence_runs, evidence_checks_ = {}, {}
    t_evidence = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_evidence_") as tmp:
        # 22c's oracle LU runs on a host core beside 22a-22b and 22d-22g.
        ahead = start_unstructured_oracle(tmp)
        for tag, phase in EVIDENCE_PHASES:
            extra = (ahead,) if phase is phase_evidence_unstructured else ()
            name, launches, twin_checks = timed(tag, phase, gpu, tmp, *extra)
            evidence_runs[name] = launches
            evidence_checks_.update(twin_checks)
    print(f"evidence drivers: phase 22 {time.perf_counter() - t_evidence:.1f} s, launches "
          f"{evidence_runs} [{gpu}]", flush=True)
    graft_runs, graft_checks, graft_layouts = timed("23 graft entry", phase_graft_entry, gpu)
    probe_runs, probe_checks = timed("24 probes", phase_probes, gpu)
    torchrun_runs, torchrun_checks = timed("25 torchrun", phase_torchrun, device, gpu,
                                           stacked_peak)
    if jax_modules_loaded():
        fail(f"imported {jax_modules_loaded()}")

    # launches: the ratio run on the full SPE10 grid; launches_by_path
    # lists every path (sharded_golden_mlmc, unstructured_agglomerated_mlmc,
    # unstructured_nested_pair_step, phase 22's evidence_<driver>, ...),
    # each run with the counts set to 0 just before it. The numbers of thomas and threefry_normal are at that grid's
    # shapes, taken in the full-grid MLMC phase:
    # max_abs_err over its three levels; ms, plain_ms, bound_ms and
    # library_ms at level 0 (thomas: one M(w)^{-1} apply, three launches).
    by_path = lambda k: {"golden_mlmc": golden[k], "sharded_golden_mlmc": sharded[k],
                         "bench_pair_step": bench_launches[k],
                         **{f"graft_entry_{name}": n[k] for name, n in graft_runs.items()},
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
                         **{f"scaled_anchor_{name}": n[k] for name, n in scaled_solvers.items()},
                         **{f"drivers_{name}": n[k] for name, n in drivers.items()},
                         **{f"spatial_golden_mlmc_{name}": n[k]
                            for name, n in spatial_golden.items()},
                         f"spatial_spe10_anchor_sp{SPATIAL_ANCHOR_SHARDS}": spatial_anchor[k],
                         **{f"evidence_{name}": n[k] for name, n in evidence_runs.items()},
                         **{f"probes_{name}": n[k] for name, n in probe_runs.items()},
                         **{f"torchrun_{name}": n[k] for name, n in torchrun_runs.items()
                            if k in n}}
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
             f"full_grid_{name}_steps": n for name, n in full_solvers.items()},
             f"spatial_full_grid_sp{SPATIAL_SHARDS}_steps": spatial_full},
         **{k: k1[k] for k in fields}, "bound_by": "bytes",
         # M(w)^{-1} on the golden level-0 tables at one shard's batch.
         "sharded_golden_shard": {k: sharded_checks["thomas"][k] for k in fields},
         # Several right-hand sides per table set: R = 2 on the level-0
         # M(w)^{-1} tables (batch 8), R = batch on the static MG's line
         # tables of the level-1 grid.
         "rhs": [{k: k1["rhs2"][k] for k in ("R", "ms", "plain_ms", "bound_ms", "abs_err")},
                 {k: k1_static[k] for k in ("R", "n", "lines", "ms", "plain_ms", "bound_ms",
                                            "abs_err")}],
         # M(w)^{-1} at each distinct (config, batch, dtype) of phase 20's
         # driver runs, level 0 (max_abs_err over the levels).
         "drivers": {p: {k: c["thomas"][k] for k in fields} for p, c in driver_checks.items()
                     if "thomas" in c},
         # The sharded M(w)^{-1}'s layouts (phase 21d): the slab x, z and
         # decoupled y lines and the spike solves with R = 2, float32 at
         # the full-grid level-0 shapes, float64 at the scaled anchor's.
         "spatial_layouts": {f"full grid sp{SPATIAL_SHARDS} float32": layouts_f32,
                             f"scaled anchor sp{SPATIAL_ANCHOR_SHARDS} float64": layouts_f64,
                             f"graft_entry dry run sp{GRAFT_DEVICES // 2} dp2 float32":
                                 graft_layouts},
         # M(w)^{-1} at each distinct (config, per-level batch, dtype) of
         # phase 22's evidence drivers, level 0 (max_abs_err over the levels).
         "evidence_drivers": {p: {k: c["thomas"][k] for k in fields}
                              for p, c in evidence_checks_.items() if "thomas" in c},
         # M(w)^{-1} at each distinct shape of phase 23's graft twin (level
         # 0; max_abs_err over the levels).
         "graft_entry": {p: {k: c["thomas"][k] for k in fields} for p, c in graft_checks.items()},
         # M(w)^{-1} at each distinct shape of phase 24's probes (the first
         # level checked; max_abs_err over the levels).
         **{p: {k: c["thomas"][k] for k in fields} for p, c in probe_checks.items()},
         # M(w)^{-1} at one rank's shard of phase 25's torchrun runs (level
         # 0; max_abs_err over the levels).
         "torchrun": {p: {k: c["thomas"][k] for k in fields} for p, c in torchrun_checks.items()},
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
         "drivers": {p: {k: c["threefry_normal"][k] for k in fields + ("library_ms",)}
                     for p, c in driver_checks.items()},
         "evidence_drivers": {p: {k: c["threefry_normal"][k]
                                  for k in fields + ("device_ms", "library_ms")}
                              for p, c in evidence_checks_.items()},
         "graft_entry": {p: {k: c["threefry_normal"][k]
                             for k in fields + ("device_ms", "library_ms")}
                         for p, c in graft_checks.items() if "threefry_normal" in c},
         **{p: {k: c["threefry_normal"][k] for k in fields + ("device_ms", "library_ms")}
            for p, c in probe_checks.items() if "threefry_normal" in c},
         "torchrun": {p: {k: c["threefry_normal"][k] for k in fields + ("device_ms", "library_ms")}
                      for p, c in torchrun_checks.items()},
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
    print(f"phase walls (s): {json.dumps(walls)} total "
          f"{time.perf_counter() - START:.1f} [{gpu}]", flush=True)
    print(json.dumps(report), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-child"]:
        torchrun_child(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
