from parelagmc_tpu_torch.mesh.structured import StructuredMesh  # noqa: F401
from parelagmc_tpu_torch.mesh.factories import (  # noqa: F401
    SPE10_NCELLS,
    SPE10_SPACING,
    make_box_mesh,
    make_egg_mesh,
    make_embedded_box_mesh,
    make_spe10_mesh,
)
