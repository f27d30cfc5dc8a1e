"""Evaluate the Bayesian likelihood per level for one prior draw. Twin of
examples/likelihood_example.py (reference analog:
examples/LikelihoodExample.cpp and the CTest golden values
"L = 0 : 0.9279...", examples/CMakeLists.txt:98-102)."""

from parelagmc_tpu_torch.examples.common import parse_args, report
from parelagmc_tpu_torch.ops.prng import PRNGKey
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import BayesianInverseProblem


def main(argv=None):
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    cfg = prob.config  # axis-order permutation applied (problems.py)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    y = bip.generate_observational_data()
    report(f"-- observational data: {y}")
    key = PRNGKey(cfg.seed + 1)
    xi = prob.sampler.sample(0, key, 1)
    for level in range(cfg.nlevels):
        w = prob.sampler.eval(level, xi, xi_level=0)
        like, cost = bip.likelihood(level, w)
        report(f"L = {level} : {float(like[0]):.8g}")


if __name__ == "__main__":
    main()
