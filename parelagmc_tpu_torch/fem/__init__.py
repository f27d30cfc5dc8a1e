from parelagmc_tpu_torch.fem.assembly import MixedLevel, build_mixed_level  # noqa: F401
from parelagmc_tpu_torch.fem.hierarchy import (  # noqa: F401
    GeometricHierarchy,
    build_geometric_hierarchy,
    build_geometric_hierarchy_from_fine,
)
