from parelagmc_tpu_torch.parallel.sharding import (  # noqa: F401
    SampleMesh,
    sample_mesh_from_config,
)
from parelagmc_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialSolver,
    slab_partition,
)
