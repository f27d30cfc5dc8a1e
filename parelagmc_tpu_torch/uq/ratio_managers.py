"""Bayesian posterior ratio estimators, single-level and multilevel.

Port of parelagmc_tpu/uq/ratio_managers.py (reference: ParELAGMC
src/SL_BayesRatio_Manager.hpp, SL_BayesRatio_Splitting_Manager.hpp,
ML_BayesRatio_Manager.hpp, ML_BayesRatio_Splitting_Manager.hpp):

* ratio estimator:     E_post[Q] ~= (sum_l E[Y_R,l]) / (sum_l E[Y_Z,l]),
  with independent prior streams for Z = Pi(u) and R = Q(u') Pi(u') and
  coupled coarse/fine evaluations sharing each stream's noise;
* splitting estimator: E_post[Q] ~= sum_l E[R_l/Z_l - R_{l+1}/Z_{l+1}]
  ("divide then subtract").

Single-level variants are the nlevels == 1 special case. Each level step
runs eagerly on the solver's device and returns (r, rc, z, zc); the 20
moment sums are accumulated on the host in float64, one copy per batch.
The key schedule is the reference's: manager key PRNGKey(seed + 101),
batch keys fold_in(fold_in(key, level), counter) with one counter over all
levels, and each batch key split into a Z key and an R key. Sample
allocation follows the reference: optimal N_l against the larger of the
R- and Z-stream estimator variances (ratio) or the Y_Ratio variance
(splitting).

`split_pair_programs` (the reference runs the Z and R streams as two
device programs there) is accepted and runs the composed step, which draws
the same stream. With it every solve of a step gets the budget
max_iterations * solve_segments, the rule of MLMCManager.pair_budget; the
reference gives the ratio solves max_iterations alone, so the two differ
only on a sample that has not converged by then.

Sample sharding (`sharding=` or config.sample_shards) follows MLMCManager:
batches rounded up to a multiple of the shard count, and the step run per
shard, the shard's fold_in(key, i) taken before the step's own split into
the Z and R keys, as the reference's sharded streams do. The coupled prior
fields come from the sampler's eval_pair where it has one.

Under a torch.distributed group of world size > 1 the walltime cost is
agreed over the ranks, and the log and checkpoint are rank 0's, as in
MLMCManager (uq/managers.py).

Tracing (utils/trace.py): each batch of `init_run` is an `mlmc.batch` span
keyed (level, key counter) with attribute manager="ratio", as MLMCManager's
are; inside it `wait.ratio_copy` spans the copies of r, rc, z and zc to
the host (counter `host_syncs.ratio_copy`) and `ratio.moments` the 20
moment sums. PARELAGMC_BATCH_TRACE=1 prints one `# batch-trace ratio`
line per batch on stderr, as MLMCManager does.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in, split
from parelagmc_tpu_torch.parallel.launch import agree_max, barrier, is_main
from parelagmc_tpu_torch.parallel.sharding import SampleMesh
from parelagmc_tpu_torch.uq.bayes import BayesianInverseProblem
from parelagmc_tpu_torch.uq.managers import check_sharding, eval_pair, level_batches
from parelagmc_tpu_torch.utils import trace
from parelagmc_tpu_torch.utils.regression import exp_weighted_regression
from parelagmc_tpu_torch.utils.timing import SteadyCostLedger, TimeManager, block_until_ready

# Moment columns (reference ML_BayesRatio_Manager.hpp:67-70 enum).
(YZ2, YZ, ABS_YZ, Z2, Z, ABS_Z, YR2, YR, ABS_YR, R2, R, ABS_R,
 YRATIO2, YRATIO, ABS_YRATIO, RATIO2, RATIO, ABS_RATIO, C, T) = range(20)
NVAR = 20


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


class BayesRatioManager:
    """Adaptive Bayesian ratio / splitting estimator manager."""

    def __init__(self, problem: BayesianInverseProblem, config: ProblemConfig,
                 nlevels: Optional[int] = None, splitting: bool = False,
                 batch_size: Optional[int] = None, sharding: Optional[SampleMesh] = None):
        self.problem = problem
        self.config = config
        self.splitting = bool(splitting)
        self.sharding = check_sharding(sharding, config, torch.device(problem.device))
        self.nlevels = int(nlevels if nlevels is not None else problem.nlevels)
        self.batch, self.level_batch = level_batches(
            config, self.nlevels, batch_size, self.sharding)
        self.eps2 = float(config.mse)
        self.auto_eps2 = self.eps2 < 0
        if self.auto_eps2:
            self.eps2 = 1.0
        self.ratio = float(config.mse_splitting_ratio)
        self.init_nsamples = int(config.initial_samples)
        self.use_walltime_cost = config.cost_model == "walltime"
        self.verbose = config.verbose

        n = self.nlevels
        self.sums = np.zeros((n, NVAR))
        self.level_nsamples = np.zeros(n, dtype=np.int64)
        self.level_nsamples_missing = np.zeros(n, dtype=np.int64)
        self.M = np.array([problem.solver.num_dofs(l) for l in range(n)], dtype=np.float64)
        self.E = np.zeros((n, NVAR))
        self.varYR = np.zeros(n)
        self.varYZ = np.zeros(n)
        self.varYRatio = np.zeros(n)
        self.cost = np.zeros(n)
        self.ml_estimator_variance = math.inf
        self.expected_discretization_error2 = math.inf
        self.actual_mse = math.inf
        # Steady-state walltime ledger (each level's first batch in this
        # process is kept out of C_l; see utils/timing.py).
        self._cost_ledger = SteadyCostLedger(n)

        self._key = PRNGKey(config.seed + 101)
        self._counter = 0
        self._steps: Dict[int, Callable] = {}
        self._device_ready = False
        self._logger = None
        if config.output_filename and is_main():
            self._logger = open(config.output_filename, "w")
            self._logger.write(
                "%13s %14s %14s %14s %14s %14s\n"
                % ("%level", "R(xi)", "Y_R(xi)", "Z(xi)", "Y_Z(xi)", "c")
            )

    # -- level steps -------------------------------------------------------------
    @property
    def solve_budget(self) -> Optional[int]:
        """Krylov budget of every solve of a step: with split_pair_programs
        max_iterations * solve_segments (MLMCManager.pair_budget's rule);
        None (config.max_iterations) otherwise."""
        if not getattr(self.config, "split_pair_programs", False):
            return None
        segments = max(1, int(getattr(self.config, "solve_segments", 1)))
        return segments * int(self.problem.solver.solver_cfg.max_iterations)

    def _step(self, level: int) -> Callable:
        """Batched estimator step for `level`: key -> (r, rc, z, zc)."""
        if level in self._steps:
            return self._steps[level]
        prob = self.problem
        prior = prob.prior
        batch = self.level_batch[level]
        if self.sharding is not None:
            batch = batch // self.sharding.n_devices
        budget = self.solve_budget
        if level == self.nlevels - 1:

            def step(key):
                kz, kr = split(key)
                zxi = prior.sample(level, kz, batch)
                xi = prior.sample(level, kr, batch)
                z, _ = prob.likelihood(level, prior.eval(level, zxi), max_iters=budget)
                r, _ = prob.compute_R(level, prior.eval(level, xi), max_iters=budget)
                zero = torch.zeros_like(z)
                return r, zero, z, zero

        else:

            def step(key):
                kz, kr = split(key)
                zxi = prior.sample(level, kz, batch)
                xi = prior.sample(level, kr, batch)
                kz_f, kz_c = eval_pair(prior, level, zxi)
                kr_f, kr_c = eval_pair(prior, level, xi)
                z, _ = prob.likelihood(level, kz_f, max_iters=budget)
                zc, _ = prob.likelihood(level + 1, kz_c, max_iters=budget)
                r, _ = prob.compute_R(level, kr_f, max_iters=budget)
                rc, _ = prob.compute_R(level + 1, kr_c, max_iters=budget)
                return r, rc, z, zc

        if self.sharding is not None:
            step = self.sharding.shard_step(step)
        self._steps[level] = step
        return step

    def _prepare_device(self) -> None:
        """Build and load the CUDA kernels before any cost timer runs."""
        if self._device_ready:
            return
        if torch.device(self.problem.device).type == "cuda":
            from parelagmc_tpu_torch import kernels

            kernels.library()
        self._device_ready = True

    def _next_key(self, level: int):
        self._counter += 1
        return fold_in(fold_in(self._key, level), self._counter)

    # -- sampling rounds ---------------------------------------------------------
    def init_run(self, nsamples: List[int]) -> None:
        if self.problem.G_obs is None:
            self.problem.generate_observational_data()
        self._prepare_device()
        for level in range(self.nlevels - 1, -1, -1):
            n = int(nsamples[level])
            if n <= 0:
                continue
            nbatches = -(-n // self.level_batch[level])
            step = self._step(level)
            timer_name = f"Ratio MC Sample -- Level {level}"
            if (self.use_walltime_cost and nbatches == 1 and not self._cost_ledger.seen(level)
                    and self._cost_ledger.nsamples[level] == 0):
                # Discarded warm-up batch on an out-of-band key, so that the
                # single real batch is a steady-state cost sample; the
                # statistics and the key counter do not move. A ledger that
                # holds steady samples (a resumed run) needs none.
                t0 = time.perf_counter()
                block_until_ready(step(fold_in(self._key, 2 ** 31 - 1 - level)))
                self._cost_ledger.add_batch(level, time.perf_counter() - t0,
                                            self.level_batch[level])
            for _ in range(nbatches):
                key = self._next_key(level)
                with trace.span("mlmc.batch", level=level, rows=self.level_batch[level],
                                batch=(level, self._counter), manager="ratio") as sp:
                    with TimeManager.timed(timer_name):
                        out = step(key)
                        block_until_ready(out)
                    with trace.wait("ratio_copy"):
                        r, rc, z, zc = (_host64(x) for x in out)
                    self._cost_ledger.add_batch(level, TimeManager.last(timer_name), r.size)
                    with trace.span("ratio.moments"):
                        self._add_moments(level, r, rc, z, zc)
                if trace.BATCH_TRACE:
                    extra = sp.attrs["counters"].get("krylov.extra_iterations", 0)
                    print(
                        f"# batch-trace ratio L{level} "
                        f"dt={TimeManager.last(timer_name):.3f}s "
                        f"{trace.batch_line_totals(sp)} extra_iterations={extra}",
                        file=sys.stderr,
                    )
        if self._logger is not None:
            self._logger.flush()
        self.compute_nsamples_mse()

    def _add_moments(self, level: int, r, rc, z, zc) -> None:
        """A batch's per-sample values (float64, host) into the level's
        moment sums and sample count, and the log."""
        coarsest = level == self.nlevels - 1
        y_r = r - rc
        y_z = z - zc
        with np.errstate(divide="ignore", invalid="ignore"):
            rat = np.where(z != 0, r / np.where(z == 0, 1.0, z), 0.0)
            rat_c = np.where(zc != 0, rc / np.where(zc == 0, 1.0, zc), 0.0)
        y_ratio = rat if coarsest else rat - rat_c
        # Cost in dofs: 2 solves per level of the pair.
        cdofs = 2.0 * self.M[level] + (0.0 if coarsest else 2.0 * self.M[level + 1])
        s = self.sums[level]
        for col, col2, col_abs, v in (
            (YR, YR2, ABS_YR, y_r), (YZ, YZ2, ABS_YZ, y_z), (R, R2, ABS_R, r),
            (Z, Z2, ABS_Z, z), (RATIO, RATIO2, ABS_RATIO, rat),
            (YRATIO, YRATIO2, ABS_YRATIO, y_ratio),
        ):
            s[col] += v.sum()
            s[col2] += (v ** 2).sum()
            s[col_abs] += np.abs(v).sum()
        s[C] += cdofs * r.size
        self.level_nsamples[level] += r.size
        if self._logger is not None:
            for i in range(r.size):
                self._logger.write(
                    "%13d %14.6g %14.6g %14.6g %14.6g %14.6g\n"
                    % (level, r[i], y_r[i], z[i], y_z[i], cdofs)
                )

    def run(self) -> float:
        self.sums[:] = 0.0
        self.level_nsamples[:] = 0
        self.level_nsamples_missing[:] = 0
        self.init_run([self.init_nsamples] * self.nlevels)
        self._adaptive_loop()
        if self.verbose and is_main():
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
                    self.init_nsamples + grain[l]
                    + int(self.level_nsamples_missing[l]) // 10,
                )
            self.init_run(grain)

    @property
    def estimate(self) -> float:
        if self.splitting:
            return float(self.E[:, YRATIO].sum())
        denom = self.E[:, YZ].sum()
        return float(self.E[:, YR].sum() / denom) if denom != 0 else math.inf

    # -- estimator mathematics -----------------------------------------------------
    def compute_nsamples_mse(self) -> None:
        n = self.level_nsamples.astype(np.float64)
        taken = n > 0
        nn = np.where(taken, n, 1.0)
        self.E = self.sums / nn[:, None]
        corr = np.where(n > 1, nn / np.maximum(nn - 1.0, 1.0), 1.0)

        def var(col2, col):
            return np.maximum((self.E[:, col2] - self.E[:, col] ** 2) * corr, 0.0)

        self.varYR = var(YR2, YR)
        self.varYZ = var(YZ2, YZ)
        self.varYRatio = var(YRATIO2, YRATIO)

        if self.use_walltime_cost:
            for l in range(self.nlevels):
                t = TimeManager.elapsed(f"Ratio MC Sample -- Level {l}")
                self.cost[l] = self._cost_ledger.cost_per_sample(
                    l, t, int(self.level_nsamples[l]))
            self.cost = agree_max(self.cost)
        else:
            self.cost = self.E[:, C].copy()

        self.alpha_R = exp_weighted_regression(self.E[:, YR], self.M, 1)
        self.alphaABS_R = exp_weighted_regression(self.E[:, ABS_YR], self.M, 1)
        self.beta_R = exp_weighted_regression(self.varYR, self.M, 1)
        self.alpha_Z = exp_weighted_regression(self.E[:, YZ], self.M, 1)
        self.alphaABS_Z = exp_weighted_regression(self.E[:, ABS_YZ], self.M, 1)
        self.beta_Z = exp_weighted_regression(self.varYZ, self.M, 1)
        # Cost GROWTH rate (cost ~ M^gamma).
        self.gamma = -exp_weighted_regression(self.cost, self.M, 0)

        def bias2(eabs, aabs):
            # Written for the positive decay rates exp_weighted_regression
            # returns (see uq/managers.py compute_nsamples_mse).
            L = self.nlevels
            if L == 1:
                return 0.0
            m = self.M[0] / self.M[1]
            if L > 3:
                return max(m ** (-2 * aabs) * eabs[1] ** 2, eabs[0] ** 2) / (
                    (m ** (2 * aabs) - 1.0) ** 2
                )
            if L == 3:
                return eabs[0] ** 2 / ((m ** aabs - 1.0) ** 2)
            return eabs[0] ** 2

        self.expected_discretization_error2 = max(
            bias2(self.E[:, ABS_YR], self.alphaABS_R),
            bias2(self.E[:, ABS_YZ], self.alphaABS_Z),
        )
        if self.auto_eps2:
            self.eps2 = self.expected_discretization_error2 / (1.0 - self.ratio)

        if self.splitting:
            self.ml_estimator_variance = float(
                np.sum(np.where(taken, self.varYRatio / nn, np.inf)))
            var_for_alloc = [self.varYRatio]
        else:
            v_r = float(np.sum(np.where(taken, self.varYR / nn, np.inf)))
            v_z = float(np.sum(np.where(taken, self.varYZ / nn, np.inf)))
            self.ml_estimator_variance = max(v_r, v_z)
            var_for_alloc = [self.varYR, self.varYZ]
        self.actual_mse = self.expected_discretization_error2 + self.ml_estimator_variance

        missing = np.zeros(self.nlevels)
        cost = np.maximum(self.cost, 1e-300)
        for v in var_for_alloc:
            prop = float(np.sum(np.sqrt(v * cost))) / (self.ratio * self.eps2)
            target = prop * np.sqrt(v / cost)
            missing = np.maximum(missing, np.ceil(target - n))
        self.level_nsamples_missing = np.maximum(missing, 0).astype(np.int64)

    # -- checkpoint / resume ------------------------------------------------------
    # The estimator state - the 20-column moment sums, sample counts, key
    # counter, MSE target, per-level cost timers AND the observational data
    # the likelihoods were computed against - round-trips through one .npz,
    # so an interrupted run resumes with the key stream continuing.
    def save_state(self, path: str) -> None:
        cost_elapsed = np.array(
            [TimeManager.elapsed(f"Ratio MC Sample -- Level {l}") for l in range(self.nlevels)]
        )
        obs = self.problem.G_obs
        if is_main():
            np.savez(
                path,
                sums=self.sums,
                level_nsamples=self.level_nsamples,
                level_nsamples_missing=self.level_nsamples_missing,
                counter=self._counter,
                eps2=self.eps2,
                seed=self.config.seed,
                splitting=self.splitting,
                cost_elapsed=cost_elapsed,
                g_obs=(_host64(obs) if obs is not None else np.zeros(0)),
                **self._cost_ledger.state(),
            )
        barrier()

    def load_state(self, path: str) -> None:
        data = np.load(path)
        if int(data["seed"]) != int(self.config.seed):
            raise ValueError("checkpoint seed does not match config.seed")
        if "splitting" not in data.files:
            raise ValueError("not a ratio-manager checkpoint (no estimator kind, splitting)")
        if bool(data["splitting"]) != self.splitting:
            raise ValueError("checkpoint estimator kind (splitting) differs")
        self.sums = data["sums"]
        self.level_nsamples = data["level_nsamples"]
        self.level_nsamples_missing = data["level_nsamples_missing"]
        self._counter = int(data["counter"])
        self.eps2 = float(data["eps2"])
        if data["g_obs"].size:
            # The same cast as every other G_obs assignment, so a resumed
            # run equals an uninterrupted one.
            self.problem.set_observational_data(data["g_obs"])
        for l, t in enumerate(data["cost_elapsed"]):
            TimeManager.get_watch(f"Ratio MC Sample -- Level {l}").elapsed = float(t)
        self._cost_ledger.load(data)
        self.compute_nsamples_mse()

    def resume(self, path: str) -> float:
        """Load a checkpoint and continue the adaptive run to the target,
        with the same final verbose report as an uninterrupted run()."""
        self.load_state(path)
        self._adaptive_loop()
        if self.verbose and is_main():
            print(self.show_me())
        return self.estimate

    # -- reporting --------------------------------------------------------------------
    def show_me(self) -> str:
        w = 42

        def row(name, val):
            return f"{name:<{w}}{val}"

        def vec(name, v):
            return f"{name:<{w}}" + " ".join(f"{x:.8g}" for x in np.atleast_1d(v))

        kind = "Splitting" if self.splitting else "Ratio"
        sl = "SL" if self.nlevels == 1 else "ML"
        lines = [
            "=" * 79,
            f"{sl}_BayesRatio{'_Splitting' if self.splitting else ''}_Manager Errors:",
            "-" * 79,
            row("R Estimate", f"{self.E[:, YR].sum():.8g}"),
            row("Z Estimate", f"{self.E[:, YZ].sum():.8g}"),
            row(f"{kind} Estimate", f"{self.estimate:.8g}"),
            row("Target MSE", f"{self.eps2:.8g}"),
            row("Actual MSE", f"{self.actual_mse:.8g}"),
            row("ML Estimator Variance", f"{self.ml_estimator_variance:.8g}"),
            row("Estimator Bias (Max of R,Z)", f"{self.expected_discretization_error2:.8g}"),
            vec("DOFS in Forward Problem", self.M),
            vec("Cost", self.cost),
            vec("NumSamples", self.level_nsamples),
            vec("E[R]", self.E[:, R]),
            vec("Var[Y_R]", self.varYR),
            vec("E[Y_R]", self.E[:, YR]),
            vec("E[Z]", self.E[:, Z]),
            vec("Var[Y_Z]", self.varYZ),
            vec("E[Y_Z]", self.E[:, YZ]),
            vec("E[Ratio]", self.E[:, RATIO]),
            vec("E[Y_Ratio]", self.E[:, YRATIO]),
            vec("Var[Y_Ratio]", self.varYRatio),
            "=" * 79,
        ]
        return "\n".join(lines)

    def close(self) -> None:
        if self._logger is not None:
            self._logger.close()
            self._logger = None


class SLBayesRatioManager(BayesRatioManager):
    """Single-level ratio estimator (reference SL_BayesRatio_Manager.hpp)."""

    def __init__(self, problem, config, splitting=False, batch_size=None,
                 sharding: Optional[SampleMesh] = None):
        super().__init__(problem, config, nlevels=1, splitting=splitting,
                         batch_size=batch_size, sharding=sharding)
