"""Single-level Bayesian posterior ratio estimation. Twin of
examples/ratio_estimator_mc.py (reference analog:
examples/RatioEstimator_MC.cpp / RatioEstimator_MC_Manager.cpp; pass
--splitting for the splitting estimator)."""

import sys

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem, SLBayesRatioManager
from parelagmc_tpu_torch.utils.timing import TimeManager


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    splitting = "--splitting" in argv
    if splitting:
        argv.remove("--splitting")
    cfg, device = parse_args(argv, mse=5e-3)
    prob = build_problem(cfg, device=device)
    cfg = prob.config  # axis-order permutation applied (problems.py)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    bip.generate_observational_data()
    mgr = SLBayesRatioManager(bip, cfg, splitting=splitting)
    est = mgr.run()
    print("FINAL SL_BayesRatio_Manager ERRORS")
    print(mgr.show_me())
    TimeManager.print_table()
    mgr.close()
    return est


if __name__ == "__main__":
    main()
