from parelagmc_tpu_torch.uq.managers import MCManager, MLMCManager  # noqa: F401
from parelagmc_tpu_torch.uq.bayes import BayesianInverseProblem  # noqa: F401
from parelagmc_tpu_torch.uq.ratio_managers import (  # noqa: F401
    BayesRatioManager,
    SLBayesRatioManager,
)
