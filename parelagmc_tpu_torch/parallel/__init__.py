from parelagmc_tpu_torch.parallel.sharding import (  # noqa: F401
    SampleMesh,
    sample_mesh_from_config,
)
