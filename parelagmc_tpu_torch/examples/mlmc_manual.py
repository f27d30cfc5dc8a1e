"""Hand-rolled MLMC level loop without the manager. Twin of
examples/mlmc_manual.py (reference analog: examples/MLMC_Manual.cpp:328-369)
- demonstrates the raw sampler/solver API: draw noise, evaluate coupled
fine/coarse realizations, accumulate Y = Q_f - Q_c moments yourself. The
keys are the port's jax.random-compatible ones, so the stream is the
original's."""

import numpy as np
import torch

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.ops.prng import PRNGKey, split
from parelagmc_tpu_torch.problems import build_problem


def main(argv=None):
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    sampler, solver = prob.sampler, prob.solver
    key = PRNGKey(cfg.seed)
    nsamples = cfg.initial_samples
    batch = cfg.batch_size
    L = cfg.nlevels
    eY, vY = np.zeros(L), np.zeros(L)
    for level in range(L - 1, -1, -1):
        if level == L - 1:
            def step(k, level=level):
                xi = sampler.sample(level, k, batch)
                q, _, _ = solver.solve_fwd(level, sampler.eval(level, xi))
                return q
        else:
            def step(k, level=level):
                xi = sampler.sample(level, k, batch)
                q, _, _ = solver.solve_fwd(level, sampler.eval(level, xi))
                qc, _, _ = solver.solve_fwd(
                    level + 1, sampler.eval(level + 1, xi, xi_level=level)
                )
                return q - qc
        ys = []
        for b in range(-(-nsamples // batch)):
            key, sub = split(key)
            ys.append(step(sub).detach().to("cpu", torch.float64).numpy())
        y = np.concatenate(ys)
        eY[level], vY[level] = y.mean(), y.var(ddof=1)
        print(f"level {level}: E[Y]={eY[level]:.6g} Var[Y]={vY[level]:.6g} N={y.size}")
    print(f"MLMC estimate: {eY.sum():.8g}")
    return eY.sum()


if __name__ == "__main__":
    main()
