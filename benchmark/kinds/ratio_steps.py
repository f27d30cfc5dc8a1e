"""Traffic kind "ratio_steps" (`level`, `batch`): back-to-back batches of one
level step of the Bayesian ratio estimator through
`BayesRatioManager.init_run`, the manager keyed PRNGKey(seed + 101); one
unit is one batch of `batch` samples. A sample is a Z draw and an R draw,
each a coupled (fine, coarse) field pair (`eval_pair`) and a cold solve
of each (`likelihood` for Z, `compute_R` for R): four solves. The
configuration's `bayes` block gives the wells, their radius, the noise,
the key of the observation data (made once, at `build`, never written to
a file) and `pressure_rtol`, the likelihood's primal tolerance.

Numbers compared (each against the limit in benchmark/limits/<cell>.json),
over `rows` rows of `batches` of the window's batches (the batch that took
the most Krylov iterations and others drawn from the seed), both streams,
fine and coarse:

* `field_gap`: `verify.field_gap` of the kept draws' fields.
* `obs_gap`: the widest |y - y_ref| / |y_ref| of the observation data.
* `loglike_gap`: the widest |log Pi - log Pi_ref| of Z's and R's
  likelihoods.
* `q_mean_gap`: the mean |Q - Q_ref| / |Q_ref| of R's QoI.
* `r_mean_gap`: the mean |R - R_ref| / |R_ref|, R = Q Pi.
* `key_miss`: batches whose Z or R key is not split(fold_in(fold_in(
  PRNGKey(seed + 101), level), counter)).
* `sum_gap`: the manager's level sums of Y_R = R - R_c and Y_Z = Z - Z_c
  against the same formed from the values returned (the wider gap).
* `nonfinite`: values of R, R_c, Z, Z_c that are not finite.

`failed` counts samples with a solve unconverged (to `pressure_rtol`) or
a value not finite.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import drive
import faults
import verify
from reference import bayes as rbayes, threefry
from reference.mixed import Precision

field_ordinals = verify.field_ordinals


def build(spec: dict, traffic: dict, device) -> dict:
    """The configuration's problem with the mix's batch at its level, its
    BayesianInverseProblem (`problem.bip`) and the observation data."""
    from parelagmc_tpu_torch.ops.prng import PRNGKey
    from parelagmc_tpu_torch.problems import Problem
    from parelagmc_tpu_torch.uq import BayesianInverseProblem

    b = spec["bayes"]
    bpl = list(spec["problem"]["batch_size_per_level"])
    bpl[traffic["level"]] = int(traffic["batch"])
    built = drive.build_problem(
        spec, device, batch_size_per_level=bpl, bayes_num_obs=len(b["wells_ft"]) // 3,
        bayes_obs_coords=tuple(b["wells_ft"]), bayes_eps=float(b["eps_ft"]),
        bayes_noise=float(b["noise"]), bayes_ref_data_file="", bayes_generate_ref_data=True)

    class BayesProblem(Problem):
        """The port's problem and, as `bip`, its BayesianInverseProblem."""

    prob = BayesProblem(*built["problem"])
    prob.bip = BayesianInverseProblem(prob.solver, prob.sampler, prob.config, prob.dtype,
                                      pressure_rtol=b["pressure_rtol"])
    prob.bip.generate_observational_data(PRNGKey(int(b["data_key"])))
    built["problem"] = prob
    return built


def instrument(rec, built: dict) -> None:
    """The sampler; Z's likelihoods and R's `compute_R` (span `darcy`),
    R's likelihood and QoI inside it (`likelihood`), and each solve
    (`solve.L<l>.b<b>`). What a batch returned is gathered in `rec.parts`
    and packed by the unit into one call."""
    bip = built["problem"].bip
    rec.wrap_sampler(built["problem"].sampler)
    rec.parts = []

    def on(name):
        return lambda args, kwargs, out: rec.parts.append((name, int(args[0]), out))

    def on_solve(args, kwargs, out) -> None:
        rec.on_solve(args, kwargs, out)
        rec.parts.append(("conv", int(args[0]), out[2]))

    rec.wrap(bip, "likelihood", "darcy", on("z"))
    rec.wrap(bip, "compute_R", "darcy", on("r"))
    rec.wrap(bip, "likelihood_and_Q", "likelihood", on("rq"))
    rec.wrap(built["problem"].solver, "solve_fwd", drive.solve_span, on_solve)


def plant(problem, fault, rel: float = 0.05) -> None:
    """The faults on Z's likelihoods and R's values, where a batch's Z and
    R are produced."""
    faults.install(problem.bip, "likelihood", fault, index=0, rel=rel)
    faults.install(problem.bip, "compute_R", fault, index=0, rel=rel)


class Traffic:
    """A mix's units on one problem: `warm()` runs every shape once (out of
    band, not recorded), `unit(k)` runs the k-th unit of the window and
    returns the samples it completed."""

    def __init__(self, built: dict, traffic: dict, seed: int, rec):
        self.prob = built["problem"]
        self.cfg = built["config"]
        self.seed = int(seed)
        self.rec = rec
        self.level = int(traffic["level"])
        self.batch = int(traffic["batch"])
        self.mgr = self._manager(self.seed)

    def _manager(self, seed: int):
        from parelagmc_tpu_torch.uq import BayesRatioManager

        return BayesRatioManager(self.prob.bip, dataclasses.replace(self.cfg, seed=int(seed)))

    def counts(self) -> List[int]:
        n = [0] * self.cfg.nlevels
        n[self.level] = self.batch
        return n

    def warm(self) -> None:
        """Two batches of the level step (the first builds state at first
        use), keyed out of band; the recorder is off."""
        self.rec.active = False
        try:
            mgr = self._manager(self.seed + 2 ** 40)
            for _ in range(2):
                mgr.init_run(self.counts())
            drive.sync(self.prob.device)
        finally:
            self.rec.active = True

    def unit(self, k: int) -> int:
        """Run unit k; the samples it completed."""
        self.rec.unit = k
        self.rec.parts.clear()
        with self.rec.span("unit"):
            self.mgr.init_run(self.counts())
        self.rec.calls.append(pack(self.rec.parts, k, self.level))
        return self.batch


def pack(parts: List[tuple], unit: int, level: int) -> dict:
    """One batch's call from what its likelihoods, compute_R and solves
    returned, in the step's order: Z fine, Z coarse, R fine, R coarse."""
    got = {(name, lv): out for name, lv, out in parts if name != "conv"}
    conv = [info.converged for name, _, info in parts if name == "conv"]
    coarse = ("z", level + 1) in got
    call = dict(unit=unit, level=level, z=got[("z", level)][0], r=got[("r", level)][0],
                pi_r=got[("rq", level)][0], q=got[("rq", level)][1],
                zc=got[("z", level + 1)][0] if coarse else None,
                rc=got[("r", level + 1)][0] if coarse else None,
                pi_rc=got[("rq", level + 1)][0] if coarse else None,
                qc=got[("rq", level + 1)][1] if coarse else None)
    call["conv"] = conv[0]
    for c in conv[1:]:
        call["conv"] = call["conv"] & c
    return call


def keep(traffic: Traffic) -> dict:
    """What the check needs of the program's state: the seed, the
    manager's level sums of Y_R and Y_Z, and the observation data."""
    from parelagmc_tpu_torch.uq import ratio_managers as rm

    sums = traffic.mgr.sums[traffic.level]
    return {"seed": traffic.seed, "sum_yr": float(sums[rm.YR]), "sum_yz": float(sums[rm.YZ]),
            "y": verify.host(traffic.prob.bip.G_obs)}


def reference(spec: dict, kinv: Optional[np.ndarray]) -> rbayes.ReferenceBayes:
    return rbayes.ReferenceBayes(spec, kinv=kinv)


def schedule_keys(seed: int, level: int, counter: int):
    """The (Z, R) keys of a ratio manager's batch."""
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(seed + 101), level), counter)
    return rbayes.split_key(key, 0), rbayes.split_key(key, 1)


def batches_of(rec, seed: int) -> List[dict]:
    """The window's batches in order, host values, with the keys they were
    drawn with and the keys of the schedule."""
    out = []
    for i, call in enumerate(rec.calls):
        b = {k: (None if v is None else verify.host(v)) for k, v in call.items()
             if k not in ("unit", "level")}
        b.update(level=call["level"], keys=(rec.keys[2 * i][2], rec.keys[2 * i + 1][2]),
                 schedule=schedule_keys(seed, call["level"], i + 1),
                 iters=sum(s[2] for s in rec.solves if s[0] == call["unit"]))
        b["conv"] = b["conv"].astype(bool)
        out.append(b)
    return out


def check(spec: dict, kinv: Optional[np.ndarray], rec, kept: dict, check_spec: dict,
          device="cpu", ref: Optional[rbayes.ReferenceBayes] = None,
          control: bool = False) -> dict:
    """The compared numbers of a run, and the counts of the result line;
    the reference computes on `device`. With `control`, the reference's CG
    in bfloat16 stands in the program's place for the observation data and
    the checked samples."""
    seed = kept["seed"]
    batches = batches_of(rec, seed)
    ref = ref or reference(spec, kinv)
    prec = Precision(device=device)
    solve = rbayes.solver_for(device)
    program = (rbayes.solver_for(device, storage="bfloat16", max_iters=verify.CONTROL_ITERS)
               if control else None)
    y_ref = ref.observations(solve, prec)
    y = ref.observations(program, prec) if control else kept["y"]
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    # verify.choose sizes a batch by its "q": the rows of R.
    picks = verify.choose([dict(b, q=b["r"]) for b in batches], int(check_spec["batches"]),
                          int(check_spec["rows"]), rng)
    like_gaps, q_gaps, r_gaps = [], [], []
    for i, rows in picks:
        b = batches[i]
        kz, kr = b["schedule"]
        n = b["r"].size
        for fine, (pi_z, pi_r, q) in ((True, ("z", "pi_r", "q")), (False, ("zc", "pi_rc", "qc"))):
            if b[pi_z] is None:
                continue
            lv = b["level"] if fine else b["level"] + 1
            wz = ref.problem.coefficients(kz, n, rows, b["level"], lv, prec)
            wr = ref.problem.coefficients(kr, n, rows, b["level"], lv, prec)
            _, lz_ref = ref.evaluate(lv, wz, solve, y_ref)
            qr_ref, lr_ref = ref.evaluate(lv, wr, solve, y_ref)
            if control:
                _, lz = ref.evaluate(lv, wz, program, y)
                qr, lr = ref.evaluate(lv, wr, program, y)
                rr = qr * np.exp(lr)
            else:
                lz, lr = np.log(b[pi_z][rows]), np.log(b[pi_r][rows])
                qr, rr = b[q][rows], b["r" if fine else "rc"][rows]
            like_gaps += [np.abs(lz - lz_ref), np.abs(lr - lr_ref)]
            q_gaps.append(np.abs(qr - qr_ref) / np.abs(qr_ref))
            rr_ref = qr_ref * np.exp(lr_ref)
            r_gaps.append(np.abs(rr - rr_ref) / np.abs(rr_ref))
    values = [b[k] for b in batches for k in ("r", "rc", "z", "zc") if b[k] is not None]
    zero = lambda v: 0.0 if v is None else v
    keys_ok = [b["keys"] == b["schedule"] for b in batches]
    failed = sum(np.sum(~b["conv"] | ~np.isfinite(b["r"]) | ~np.isfinite(b["z"])
                        | ~np.isfinite(zero(b["rc"])) | ~np.isfinite(zero(b["zc"])))
                 for b in batches)
    return {
        "numbers": {
            "field_gap": verify.field_gap(rec, ref.problem, int(check_spec["rows"]), seed, prec),
            "obs_gap": float(np.max(np.abs(y - y_ref) / np.abs(y_ref))),
            "loglike_gap": float(np.max(np.concatenate(like_gaps))),
            "q_mean_gap": float(np.mean(np.concatenate(q_gaps))),
            "r_mean_gap": float(np.mean(np.concatenate(r_gaps))),
            "key_miss": int(len(keys_ok) - sum(keys_ok)),
            "sum_gap": max(
                verify.sum_gap(kept["sum_yr"], [float(np.sum(b["r"] - zero(b["rc"])))
                                                for b in batches]),
                verify.sum_gap(kept["sum_yz"], [float(np.sum(b["z"] - zero(b["zc"])))
                                                for b in batches])),
            "nonfinite": int(sum(np.sum(~np.isfinite(v)) for v in values)),
        },
        "attempted": int(sum(b["r"].size for b in batches)),
        "failed": int(failed),
        "checked": [(batches[i]["level"], len(rows)) for i, rows in picks],
    }
