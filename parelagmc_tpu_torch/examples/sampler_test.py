"""Statistical validation of random-field samplers, side by side. Twin of
examples/sampler_test.py.

Reference analog: examples/SamplerTest.cpp (+ PDESamplerTest,
EmbeddedPDESamplerTest, ProjectionPDESamplerTest): per level, estimate the
expectation and marginal-variance fields over nsamples realizations and
print their L2 errors against the exact values (0 mean for Gaussian /
exp-moments for log-normal; unit target variance), via the
ReduceAndOutputRandomFieldErrors convention (src/Utilities.hpp:177-185).

Samplers compared: analytic-KLE, Matern-KLE, SPDE (plain), SPDE matching
embedding, SPDE mortar projection - the reference compares the same set.
"""

import dataclasses

import numpy as np
import torch

from parelagmc_tpu_torch.examples.common import parse_args, report
from parelagmc_tpu_torch.ops.prng import PRNGKey, split
from parelagmc_tpu_torch.problems import build_problem


# (name, config overrides) of the samplers the driver compares.
VARIANTS = (
    ("analytic-KLE", dict(sampler_name="analytic", embedding="none")),
    ("matern-KLE", dict(sampler_name="matern", embedding="none")),
    ("SPDE", dict(sampler_name="pde", embedding="none")),
    ("SPDE-embedded", dict(sampler_name="pde", embedding="matching")),
    ("SPDE-projection", dict(sampler_name="pde", embedding="projection")),
)


def field_errors(prob, nsamples, key):
    """Per level: (expectation L2 error, marginal-variance L2 error)."""
    cfg, sampler = prob.config, prob.sampler
    out = []
    batch = cfg.batch_size
    for level in range(cfg.nlevels):
        W = prob.hierarchy.levels[level].W
        n = prob.hierarchy.levels[level].n_s
        mean = np.zeros(n)
        m2 = np.zeros(n)
        taken = 0
        while taken < nsamples:
            key, sub = split(key)
            s = sampler.eval(level, sampler.sample(level, sub, batch))
            s = s.detach().to("cpu", torch.float64).numpy()
            mean += s.sum(axis=0)
            m2 += (s ** 2).sum(axis=0)
            taken += s.shape[0]
        mean /= taken
        var = m2 / taken - mean ** 2
        sigma2 = float(cfg.variance)
        if cfg.lognormal:
            exact_mean = np.exp(sigma2 / 2.0)
            exact_var = np.exp(sigma2) * (np.exp(sigma2) - 1.0)
        else:
            exact_mean = 0.0
            exact_var = sigma2
        err_e = np.sqrt((W * (mean - exact_mean) ** 2).sum())
        err_v = np.sqrt((W * (var - exact_var) ** 2).sum())
        out.append((err_e, err_v))
    return out


def main(argv=None):
    cfg, device = parse_args(argv)
    nsamples = cfg.initial_samples * 10
    key = PRNGKey(cfg.seed)
    report(f"-- SamplerTest: {nsamples} samples, lognormal={cfg.lognormal}")
    for name, kw in VARIANTS:
        vcfg = dataclasses.replace(cfg, **kw)
        prob = build_problem(vcfg, device=device)
        errs = field_errors(prob, nsamples, key)
        for level, (ee, ev) in enumerate(errs):
            report(
                "%-16s L%d  ||E[s]-exact||_L2 = %12.6g   ||Var[s]-exact||_L2 = %12.6g"
                % (name, level, ee, ev)
            )


if __name__ == "__main__":
    main()
