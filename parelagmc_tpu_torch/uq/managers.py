"""Multilevel Monte Carlo estimator manager.

Port of `MLMCManager` from parelagmc_tpu/uq/managers.py: the same
estimator mathematics (per-level moment sums of Y_l = Q_l - Q_{l+1},
unbiased variances, kurtosis, alpha/beta/gamma regressions, rate-
extrapolated bias, optimal N_l ~ sqrt(V_l / C_l) against a target MSE),
the same key schedule (batch keys fold_in(fold_in(key, level), counter),
so fixed-seed runs draw the reference's samples), and the same walltime
cost model with the steady-state ledger.

Each level step runs eagerly on the solver's device: the coarsest level
evaluates Q alone, the others the coupled (fine, coarse) pair with shared
noise and a warm-started fine solve (with adjoint_qoi the coarse adjoint
warm-starts the fine one too). The kernels are built before any cost timer
runs, so a first-use nvcc build never enters C_l.

`split_pair_programs` with `solve_segments` = n: the reference splits the
pair step into bounded device executions (a TPU worker limit) and
continues an unconverged pair solve for up to n executions of
max_iterations each. Here each pair solve runs composed, as one solve with
that total budget, n * max_iterations.

`save_state`/`load_state`/`resume` round-trip the estimator state (moment
sums, sample counts, key counter, MSE target, cost timers and ledger)
through one .npz file, so an interrupted adaptive run continues with the
same key stream; a checkpoint of the JAX package's managers loads too (it
carries no iteration sums, which then start at zero). `MCManager` is the
one-level special case.

Sample sharding (`sharding=`, or config.sample_shards through
parallel.sample_mesh_from_config): every batch is rounded up to a multiple
of the shard count and each level step runs per shard (SampleMesh.shard_step:
shard i keyed fold_in(key, i), local batch batch // n). Each step returns
its Krylov iterations per sample (each shard's count broadcast over its
local batch), so the iteration sums mean what the reference's do.

Under a torch.distributed group of world size > 1 (torchrun, see
parallel/launch.py) every rank drives the manager and holds the same global
batch, but each times itself: the walltime C_l is agreed over the ranks
(the maximum, the pace of a step whose collectives wait for the slowest
rank) before it sets N_l, so every rank takes the same rounds and batches.
The per-sample log and save_state are written by rank 0 alone; load_state
and resume run on every rank.

Tracing (utils/trace.py): each batch of `init_run` is an `mlmc.batch` span
keyed (level, key counter), with the waits for the step's result
(`wait.manager_sync`) and for its copy to the host (`wait.manager_copy`)
inside. PARELAGMC_BATCH_TRACE=1 prints one stderr line per batch: its wall,
iterations, and from the span its set-up, Krylov and wait milliseconds,
host syncs and Krylov restarts.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.utils.regression import exp_weighted_regression
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.parallel.launch import agree_max, barrier, is_main
from parelagmc_tpu_torch.parallel.sharding import SampleMesh, sample_mesh_from_config
from parelagmc_tpu_torch.utils import trace
from parelagmc_tpu_torch.utils.timing import SteadyCostLedger, TimeManager, block_until_ready

# Moment-sum columns (reference: MLMC_Manager.hpp:65 enum).
Y, Y2, Y3, Y4, ABSY, Q, Q2, ABSQ, C = range(9)
NVAR = 9


def _device_of(solver) -> torch.device:
    return torch.device(getattr(solver, "device", "cpu"))


def check_sharding(sharding: Optional[SampleMesh], config, device) -> Optional[SampleMesh]:
    """The manager's SampleMesh: `sharding`, else config.sample_shards's.
    Sample sharding does not nest around darcy_solver.spatial_shards."""
    if sharding is None:
        sharding = sample_mesh_from_config(config, device)
    if sharding is not None and int(
            getattr(config.darcy_solver, "spatial_shards", 0) or 0) > 1:
        raise ValueError(
            "manager-level sample sharding (SampleMesh) cannot nest around "
            "darcy_solver.spatial_shards; pass sharding=None")
    return sharding


def level_batches(config, nlevels: int, batch_size: Optional[int],
                  sharding: Optional[SampleMesh]):
    """(batch, per-level batches, finest first): batch_size or
    config.batch_size, or config.batch_size_per_level; each rounded up to a
    multiple of the shard count."""
    batch = int(batch_size if batch_size is not None else config.batch_size)
    level_batch = [batch] * nlevels
    bpl = getattr(config, "batch_size_per_level", None)
    if bpl:
        if len(bpl) != nlevels:
            raise ValueError(
                f"batch_size_per_level has {len(bpl)} entries for {nlevels} levels")
        level_batch = [int(b) for b in bpl]
    if sharding is not None:
        batch = sharding.round_batch(batch)
        level_batch = [sharding.round_batch(b) for b in level_batch]
    return batch, level_batch


def eval_pair(sampler, level: int, xi: torch.Tensor):
    """Coupled (fine, coarse) fields with shared noise: the sampler's
    eval_pair where it has one, else two evaluations."""
    if hasattr(sampler, "eval_pair"):
        return sampler.eval_pair(level, xi)
    return sampler.eval(level, xi), sampler.eval(level + 1, xi, xi_level=level)


def per_sample(iterations: int, q: torch.Tensor) -> torch.Tensor:
    """A solve's batch-global iteration count broadcast over its samples."""
    return torch.full(q.shape, float(iterations), dtype=torch.float64, device=q.device)


class MLMCManager:
    """Adaptive multilevel Monte Carlo estimator over batched level steps."""

    def __init__(self, solver, sampler, config: ProblemConfig,
                 nlevels: Optional[int] = None, batch_size: Optional[int] = None,
                 sharding: Optional[SampleMesh] = None):
        self.solver = solver
        self.sampler = sampler
        self.config = config
        self.sharding = check_sharding(sharding, config, _device_of(solver))
        self.nlevels = int(nlevels if nlevels is not None else config.nlevels)
        self.batch, self.level_batch = level_batches(
            config, self.nlevels, batch_size, self.sharding)
        self.eps2 = float(config.mse)
        self.auto_eps2 = self.eps2 < 0
        if self.auto_eps2:
            self.eps2 = 1.0
        self.ratio = float(config.mse_splitting_ratio)
        self.init_nsamples = [int(config.initial_samples)] * self.nlevels
        if config.initial_samples_per_level is not None and len(
            config.initial_samples_per_level
        ) == self.nlevels:
            self.init_nsamples = [int(n) for n in config.initial_samples_per_level]
        self.use_walltime_cost = config.cost_model == "walltime"
        self.verbose = config.verbose

        self.sums = np.zeros((self.nlevels, NVAR))
        self.level_nsamples = np.zeros(self.nlevels, dtype=np.int64)
        self.level_nsamples_missing = np.zeros(self.nlevels, dtype=np.int64)
        self.M = np.array(
            [solver.num_dofs(l) for l in range(self.nlevels)], dtype=np.float64
        )
        self.ml_estimator_variance = math.inf
        self.expected_discretization_error2 = math.inf
        self.actual_mse = math.inf
        self.alpha = self.alphaABS = self.beta = self.gamma = 0.0
        self.eY = np.zeros(self.nlevels)
        self.eABSY = np.zeros(self.nlevels)
        self.eQ = np.zeros(self.nlevels)
        self.eABSQ = np.zeros(self.nlevels)
        self.eC = np.zeros(self.nlevels)
        self.varY = np.zeros(self.nlevels)
        self.varQ = np.zeros(self.nlevels)
        self.kurtosis = np.zeros(self.nlevels)
        self.consistency = np.zeros(self.nlevels)
        self.VC = np.zeros(self.nlevels)
        self.cost = np.zeros(self.nlevels)
        # Running sum of per-sample Krylov iterations (solver health).
        self._iter_sums = np.zeros(self.nlevels)
        self._cost_ledger = SteadyCostLedger(self.nlevels)

        self._key = PRNGKey(config.seed)
        self._counter = 0
        self._steps: Dict[int, Callable] = {}
        self._device_ready = False
        self._logger = None
        if config.output_filename and is_main():
            self._logger = open(config.output_filename, "w")
            self._logger.write(
                "%13s %14s %14s %14s %14s\n" % ("%level", "Y(xi)", "Q(xi)", "Q_c(xi)", "c")
            )

    # -- level steps -------------------------------------------------------------
    def _step(self, level: int) -> Callable:
        """Batched estimator step for `level`: key -> (q, qc, iterations per
        sample)."""
        if level in self._steps:
            return self._steps[level]
        sampler, solver = self.sampler, self.solver
        batch = self.level_batch[level]
        if self.sharding is not None:
            batch = batch // self.sharding.n_devices
        if level == self.nlevels - 1:

            def step(key):
                xi = sampler.sample(level, key, batch)
                s = sampler.eval(level, xi)
                q, _, info = solver.solve_fwd(level, s)
                return q, torch.zeros_like(q), per_sample(info.iterations, q)

        else:
            budget = self.pair_budget

            # Coarse-then-fine with the warm-started fine solve (the
            # reference's Eval(l+1) -> Eval(l, ..., use_init) pattern); a
            # sampler's eval_pair warm-starts its own fine solve too.
            def step(key):
                xi = sampler.sample(level, key, batch)
                s_f, s_c = eval_pair(sampler, level, xi)
                q, qc, info_f, info_c = solver.solve_fwd_pair(level, s_f, s_c,
                                                              max_iters=budget)
                return q, qc, per_sample(info_f.iterations + info_c.iterations, q)

        if self.sharding is not None:
            step = self.sharding.shard_step(step)
        self._steps[level] = step
        return step

    @property
    def pair_budget(self) -> Optional[int]:
        """Krylov budget of each pair solve: with split_pair_programs the
        reference's solve_segments bounded executions of max_iterations
        each, run as one solve; None (config.max_iterations) otherwise."""
        if not getattr(self.config, "split_pair_programs", False):
            return None
        segments = max(1, int(getattr(self.config, "solve_segments", 1)))
        return segments * int(self.solver.solver_cfg.max_iterations)

    def _prepare_device(self) -> None:
        """Build and load the CUDA kernels before any cost timer runs."""
        if self._device_ready:
            return
        if _device_of(self.solver).type == "cuda":
            from parelagmc_tpu_torch import kernels

            kernels.library()
        self._device_ready = True

    def _next_key(self, level: int):
        self._counter += 1
        return fold_in(fold_in(self._key, level), self._counter)

    # -- sampling rounds ---------------------------------------------------------
    def init_run(self, nsamples: List[int]) -> None:
        """One sampling round: take >= nsamples[l] new samples per level
        (rounded up to whole batches), update the statistics and the optimal
        allocation (reference: MLMC_Manager::InitRun)."""
        self._prepare_device()
        for level in range(self.nlevels - 1, -1, -1):
            n = int(nsamples[level])
            if n <= 0:
                continue
            nbatches = -(-n // self.level_batch[level])
            step = self._step(level)
            timer_name = f"MC Sample -- Level {level}"
            if (self.use_walltime_cost and nbatches == 1 and not self._cost_ledger.seen(level)
                    and self._cost_ledger.nsamples[level] == 0):
                # Single-batch level: run one DISCARDED warmup batch on an
                # out-of-band key, so the real batch below is a steady-state
                # cost sample; the main key counter and the statistics do
                # not move (fixed-seed runs keep their streams). A ledger
                # that holds steady samples (a resumed run) needs none.
                t0 = time.perf_counter()
                block_until_ready(step(fold_in(self._key, 2 ** 31 - 1 - level))[0])
                self._cost_ledger.add_batch(
                    level, time.perf_counter() - t0, self.level_batch[level]
                )
            for _ in range(nbatches):
                key = self._next_key(level)
                with trace.span("mlmc.batch", level=level, rows=self.level_batch[level],
                                batch=(level, self._counter)) as sp:
                    with TimeManager.timed(timer_name):
                        q, qc, iters = step(key)
                        with trace.wait("manager_sync"):
                            block_until_ready((q, qc))
                    with trace.wait("manager_copy"):
                        q = q.detach().to("cpu", torch.float64).numpy()
                        qc = qc.detach().to("cpu", torch.float64).numpy()
                        self._iter_sums[level] += float(iters.sum())
                        iters_max = float(iters.max()) if trace.BATCH_TRACE else 0.0
                    self._cost_ledger.add_batch(level, TimeManager.last(timer_name), q.size)
                    y = q - qc
                    cost_dofs = self.M[level] + (
                        self.M[level + 1] if level < self.nlevels - 1 else 0.0
                    )
                    self.sums[level, Y] += y.sum()
                    self.sums[level, Y2] += (y ** 2).sum()
                    self.sums[level, Y3] += (y ** 3).sum()
                    self.sums[level, Y4] += (y ** 4).sum()
                    self.sums[level, ABSY] += np.abs(y).sum()
                    self.sums[level, Q] += q.sum()
                    self.sums[level, Q2] += (q ** 2).sum()
                    self.sums[level, ABSQ] += np.abs(q).sum()
                    self.sums[level, C] += cost_dofs * q.size
                    self.level_nsamples[level] += q.size
                    if self._logger is not None:
                        for i in range(q.size):
                            self._logger.write(
                                "%13d %14.6g %14.6g %14.6g %14.6g\n"
                                % (level, y[i], q[i], qc[i], cost_dofs)
                            )
                if trace.BATCH_TRACE:
                    print(
                        f"# batch-trace L{level} "
                        f"dt={TimeManager.last(timer_name):.3f}s "
                        f"iters={iters_max:.0f} {trace.batch_line_totals(sp)}",
                        file=sys.stderr,
                    )
        if self._logger is not None:
            self._logger.flush()
        self.compute_nsamples_mse()

    def run(self) -> float:
        """Adaptive MLMC until the estimator variance target is met
        (reference: MLMC_Manager::Run). Returns the estimate."""
        self.sums[:] = 0.0
        self.level_nsamples[:] = 0
        self.level_nsamples_missing[:] = 0
        self._iter_sums[:] = 0.0
        self.init_run(self.init_nsamples)
        self._adaptive_loop()
        if self.verbose and is_main():
            print("FINAL MLMC ERRORS")
            print(self.show_me())
        return self.estimate

    def _adaptive_loop(self) -> None:
        """Grow the per-level rounds toward the missing-samples target until
        the estimator variance meets ratio * eps^2 (shared by run and
        resume, so a resumed run follows the same schedule)."""
        grain = [0] * self.nlevels
        while self.ml_estimator_variance > self.ratio * self.eps2:
            for l in range(self.nlevels):
                grain[l] = min(
                    int(self.level_nsamples_missing[l]),
                    self.init_nsamples[l] + grain[l]
                    + int(self.level_nsamples_missing[l]) // 10,
                )
            self.init_run(grain)

    @property
    def estimate(self) -> float:
        return float(self.eY.sum())

    @property
    def solver_iterations(self) -> np.ndarray:
        """Mean Krylov iterations per sample per level."""
        return self._iter_sums / np.maximum(self.level_nsamples, 1)

    # -- estimator mathematics -----------------------------------------------
    def compute_nsamples_mse(self) -> None:
        n = self.level_nsamples.astype(np.float64)
        taken = n > 0
        nn = np.where(taken, n, 1.0)
        E = self.sums / nn[:, None]
        self.eY = E[:, Y]
        self.eABSY = E[:, ABSY]
        self.eQ = E[:, Q]
        self.eABSQ = E[:, ABSQ]
        self.eC = E[:, C]
        eY2 = E[:, Y2]
        eQ2 = E[:, Q2]
        with np.errstate(divide="ignore", invalid="ignore"):
            self.kurtosis = np.where(eY2 > 0, E[:, Y4] / np.maximum(eY2, 1e-300) ** 2, 0.0)
        corr = np.where(n > 1, nn / np.maximum(nn - 1.0, 1.0), 1.0)
        self.varY = np.maximum((eY2 - self.eY ** 2) * corr, 0.0)
        self.varQ = np.maximum((eQ2 - self.eQ ** 2) * corr, 0.0)

        # Telescoping consistency |E[Q_l] - E[Q_{l+1}] - E[Y_l]| (the
        # reference's code has a '+', MLMC_Manager.cpp:329).
        for l in range(self.nlevels - 1):
            denom = 3.0 * (
                math.sqrt(self.varQ[l]) + math.sqrt(self.varQ[l + 1])
                + math.sqrt(self.varY[l])
            )
            self.consistency[l] = (
                abs(self.eQ[l] - self.eQ[l + 1] - self.eY[l]) / denom
                if denom > 0
                else 0.0
            )

        self.alpha = exp_weighted_regression(self.eY, self.M, 1)
        self.alphaABS = exp_weighted_regression(self.eABSY, self.M, 1)
        self.beta = exp_weighted_regression(self.varY, self.M, 1)

        # Rate-extrapolated squared bias (reference MLMC_Manager.cpp:337-355,
        # written for the positive decay rates exp_weighted_regression returns).
        L = self.nlevels
        if L == 1:
            self.expected_discretization_error2 = 0.0
        else:
            m = self.M[0] / self.M[1]
            aABS = self.alphaABS
            if L > 3:
                self.expected_discretization_error2 = max(
                    m ** (-2.0 * aABS) * self.eABSY[1] ** 2, self.eABSY[0] ** 2
                ) / ((m ** (2.0 * aABS) - 1.0) ** 2)
            elif L == 3:
                self.expected_discretization_error2 = self.eABSY[0] ** 2 / (
                    (m ** aABS - 1.0) ** 2
                )
            else:
                self.expected_discretization_error2 = self.eABSY[0] ** 2

        if self.auto_eps2:
            self.eps2 = self.expected_discretization_error2 / (1.0 - self.ratio)

        self.ml_estimator_variance = float(
            np.sum(np.where(taken, self.varY / nn, np.inf))
        )
        self.actual_mse = self.expected_discretization_error2 + self.ml_estimator_variance

        # Per-level cost: steady-state walltime per sample, or dofs.
        if self.use_walltime_cost:
            for l in range(self.nlevels):
                t = TimeManager.elapsed(f"MC Sample -- Level {l}")
                self.cost[l] = self._cost_ledger.cost_per_sample(
                    l, t, int(self.level_nsamples[l])
                )
            self.cost = agree_max(self.cost)
        else:
            self.cost = self.eC.copy()
        # Gamma is the cost GROWTH rate (cost ~ M^gamma).
        self.gamma = -exp_weighted_regression(self.cost, self.M, 0)

        prop = float(np.sum(np.sqrt(self.varY * np.maximum(self.cost, 1e-300)))) / (
            self.ratio * self.eps2
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            target = prop * np.sqrt(self.varY / np.maximum(self.cost, 1e-300))
        missing = np.ceil(target - n)
        self.level_nsamples_missing = np.maximum(missing, 0).astype(np.int64)
        self.VC = self.varY * self.cost

    # -- checkpoint / resume -----------------------------------------------------
    def save_state(self, path: str) -> None:
        """Write the estimator state to `path` (.npz): rank 0 writes, every
        rank returns once it is written."""
        cost_elapsed = np.array(
            [TimeManager.elapsed(f"MC Sample -- Level {l}") for l in range(self.nlevels)]
        )
        if is_main():
            np.savez(
                path,
                sums=self.sums,
                level_nsamples=self.level_nsamples,
                level_nsamples_missing=self.level_nsamples_missing,
                counter=self._counter,
                eps2=self.eps2,
                seed=self.config.seed,
                cost_elapsed=cost_elapsed,
                iter_sums=self._iter_sums,
                **self._cost_ledger.state(),
            )
        barrier()

    def load_state(self, path: str) -> None:
        data = np.load(path)
        if int(data["seed"]) != int(self.config.seed):
            raise ValueError("checkpoint seed does not match config.seed")
        self.sums = data["sums"]
        self.level_nsamples = data["level_nsamples"]
        self.level_nsamples_missing = data["level_nsamples_missing"]
        self._counter = int(data["counter"])
        self.eps2 = float(data["eps2"])
        # A checkpoint of the JAX package carries no iteration sums.
        self._iter_sums = (data["iter_sums"] if "iter_sums" in data.files
                           else np.zeros(self.nlevels))
        for l, t in enumerate(data["cost_elapsed"]):
            TimeManager.get_watch(f"MC Sample -- Level {l}").elapsed = float(t)
        self._cost_ledger.load(data)
        self.compute_nsamples_mse()

    def resume(self, path: str) -> float:
        """Load a checkpoint and continue the adaptive run to the target."""
        self.load_state(path)
        self._adaptive_loop()
        return self.estimate

    # -- reporting --------------------------------------------------------------
    def show_me(self) -> str:
        w = 42

        def row(name, val):
            return f"{name:<{w}}{val}"

        def vec(name, v):
            return f"{name:<{w}}" + " ".join(f"{x:.8g}" for x in np.atleast_1d(v))

        lines = [
            "=" * 79,
            "MLMC Manager Errors:",
            "-" * 79,
            row("Estimate", f"{self.estimate:.8g}"),
            row("Target MSE", f"{self.eps2:.8g}"),
            row("Actual MSE", f"{self.actual_mse:.8g}"),
            row("ML Estimator Variance", f"{self.ml_estimator_variance:.8g}"),
            row("Estimator Bias", f"{self.expected_discretization_error2:.8g}"),
            row("Alpha", f"{self.alpha:.8g}"),
            row("AlphaAbs", f"{self.alphaABS:.8g}"),
            row("Beta", f"{self.beta:.8g}"),
            row("Gamma", f"{self.gamma:.8g}"),
            "",
            vec("DOFS in Forward Problem", self.M),
            vec("C_l", self.cost),
            vec("NumSamples", self.level_nsamples),
            vec("E[Y_l]", self.eY),
            vec("E[|Y_l|]", self.eABSY),
            vec("Var[Y_l]", self.varY),
            vec("E[Q_l]", self.eQ),
            vec("E[|Q_l|]", self.eABSQ),
            vec("Var[Q_l]", self.varQ),
            vec("V[Y_l]*C_l", self.VC),
            vec("Consistency", self.consistency),
            vec("Kurtosis", self.kurtosis),
            vec("Solver iterations (mean)", self.solver_iterations),
            "=" * 79,
        ]
        return "\n".join(lines)

    def close(self) -> None:
        if self._logger is not None:
            self._logger.close()
            self._logger = None


class MCManager(MLMCManager):
    """Single-level Monte Carlo on the finest level with on-the-fly N to hit
    the target MSE (reference: src/MC_Manager.cpp): the one-level special
    case of the MLMC machinery (Y == Q, zero bias estimate)."""

    def __init__(self, solver, sampler, config: ProblemConfig, batch_size=None,
                 sharding: Optional[SampleMesh] = None):
        super().__init__(solver, sampler, config, nlevels=1, batch_size=batch_size,
                         sharding=sharding)

    def show_me(self) -> str:
        return super().show_me().replace("MLMC Manager", "SLMC Manager")
