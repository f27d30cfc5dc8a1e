"""Generate and store reference observational data for Bayesian runs.
Twin of examples/compute_reference_obs_data.py (reference analog:
examples/ComputeReferenceObservationalData.cpp)."""

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem


def main(argv=None):
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    cfg = prob.config  # axis-order permutation applied (problems.py)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    y = bip.generate_observational_data()
    print(f"reference observational data -> {cfg.bayes_ref_data_file}: {y}")


if __name__ == "__main__":
    main()
