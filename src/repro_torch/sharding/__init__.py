"""repro_torch.sharding — element-parallel partitioning of the FEM Map over
``torch.distributed`` ranks (the FEM half of ``repro.sharding``)."""

from .partitioning import (  # noqa: F401
    COLLECTIVES,
    FEM_MESH_AXIS,
    FemMesh,
    fem_mesh,
    reduce_from_shards,
    reset_collectives,
    resolve_fem_mesh,
    shard_leaves,
    to_shard,
)
