"""Multilevel Bayesian posterior ratio estimation. Twin of
examples/ratio_estimator_mlmc.py (reference analog:
examples/RatioEstimator_MLMC.cpp / RatioEstimator_MLMC_Manager.cpp; pass
--splitting for the E[R/Z] splitting estimator,
ML_BayesRatio_Splitting_Manager)."""

import sys

from parelagmc_tpu_torch.examples.common import parse_args, report
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem, BayesRatioManager
from parelagmc_tpu_torch.utils.timing import TimeManager


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    splitting = "--splitting" in argv
    if splitting:
        argv.remove("--splitting")
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    cfg = prob.config  # axis-order permutation applied (problems.py)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    bip.generate_observational_data()
    mgr = BayesRatioManager(bip, cfg, splitting=splitting)
    est = mgr.run()
    report(f"FINAL {'ML_BayesRatio_Splitting' if splitting else 'ML_BayesRatio'}_Manager ERRORS")
    report(mgr.show_me())
    TimeManager.print_table()
    mgr.close()
    return est


if __name__ == "__main__":
    main()
