"""Mixed Darcy forward solves with one random permeability realization per
level. Twin of examples/darcy_random_input.py (reference analog:
examples/DarcyTest_RandomInput.cpp and the CTest (level, QoI, dofs) table,
examples/CMakeLists.txt:91-95)."""

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.problems import build_problem


def main(argv=None):
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    key = PRNGKey(cfg.seed)
    print(f"-- DarcyTest_RandomInput: sampler={cfg.sampler_name}")
    print("%8s %16s %12s" % ("level", "Q", "dofs"))
    for level in range(cfg.nlevels):
        xi = prob.sampler.sample(level, fold_in(key, level), 1)
        s = prob.sampler.eval(level, xi)
        Q, cost, info = prob.solver.solve_fwd(level, s)
        print("%8d %16.8g %12d" % (level, float(Q[0]), prob.solver.num_dofs(level)))


if __name__ == "__main__":
    main()
