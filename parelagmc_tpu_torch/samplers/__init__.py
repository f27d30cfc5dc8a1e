from parelagmc_tpu_torch.samplers.base import MLSampler  # noqa: F401
from parelagmc_tpu_torch.samplers.pde import (  # noqa: F401
    EmbeddedSPDESampler,
    L2ProjectionSPDESampler,
    SPDESampler,
)
