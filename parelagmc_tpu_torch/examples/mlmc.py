"""Adaptive MLMC estimation of a Darcy QoI with a random coefficient field.

Twin of examples/mlmc.py. Reference analog: examples/MLMC.cpp (and
MLMC_EmbeddedPDESampler.cpp / MLMC_ProjectionPDESampler.cpp via
--embedding): choose a sampler (--sampler pde|analytic|matern), build the
multilevel hierarchy, run the adaptive MLMC manager to the target MSE and
print the ShowMe dashboard (golden anchor: estimate ~2.56 on the default
parameters, examples/CMakeLists.txt:76-80).

Run: python -m parelagmc_tpu_torch.examples.mlmc [--device cuda:0] [--xml-file f.xml] ...
"""

from parelagmc_tpu_torch.examples.common import parse_args, report
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.uq import MLMCManager
from parelagmc_tpu_torch.utils.timing import TimeManager


def main(argv=None):
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    report(f"-- MLMC Run: sampler={cfg.sampler_name} embedding={cfg.embedding}")
    est = mgr.run()
    report("FINAL MLMC ERRORS")
    report(mgr.show_me())
    TimeManager.print_table()
    mgr.close()
    return est


if __name__ == "__main__":
    main()
