"""Deterministic mixed Darcy forward solve per level. Twin of
examples/darcy_test.py.

Reference analog: examples/DarcyTest.cpp + the CTest golden table of
(level, iterations, dofs) (examples/CMakeLists.txt:62-66). With the
default golden parameters (4^3 hex cube of side 2, two refinements) the
dof column reproduces 17152 / 2240 / 304 exactly and the QoI (effective
permeability with k = 1) is the analytic value 2.0 on every level.

Run: python -m parelagmc_tpu_torch.examples.darcy_test [--device cuda:0] [--refinements N] ...
"""

import torch

from parelagmc_tpu_torch.examples.common import parse_args, report
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.utils.timing import TimeManager, block_until_ready


def main(argv=None):
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    report(f"-- DarcyTest: mesh={cfg.mesh} levels={cfg.nlevels} qoi={cfg.qoi}")
    report("%8s %8s %12s %16s" % ("level", "iters", "dofs", "Q"))
    for level in range(cfg.nlevels):
        w = torch.ones((1, prob.hierarchy.levels[level].n_s), dtype=prob.dtype,
                       device=prob.device)
        with TimeManager.timed(f"Darcy: Mult -- Level {level}"):
            Q, cost, info = prob.solver.solve_fwd(level, w)
            block_until_ready(Q)
        report(
            "%8d %8d %12d %16.8g"
            % (level, int(info.iterations), prob.solver.num_dofs(level), float(Q[0]))
        )
    TimeManager.print_table()


if __name__ == "__main__":
    main()
