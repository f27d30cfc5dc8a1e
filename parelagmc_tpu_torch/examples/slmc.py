"""Single-level Monte Carlo on the finest level. Twin of examples/slmc.py
(reference analog: examples/SLMC.cpp / SLMC_ProjectionPDESampler.cpp via
--embedding)."""

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MCManager
from parelagmc_tpu_torch.utils.timing import TimeManager


def main(argv=None):
    cfg, device = parse_args(argv, mse=5e-3)
    prob = build_problem(cfg, device=device)
    mgr = MCManager(prob.solver, prob.sampler, cfg)
    est = mgr.run()
    print("FINAL SLMC ERRORS")
    print(mgr.show_me())
    TimeManager.print_table()
    mgr.close()
    return est


if __name__ == "__main__":
    main()
