"""repro_torch.sharding — element-parallel partitioning of the FEM Map over
``torch.distributed`` ranks, and the LM harness's logical-axis layout on
DTensor (the two halves of ``repro.sharding``)."""

from .partitioning import (  # noqa: F401
    COLLECTIVES,
    FEM_MESH_AXIS,
    RULES_MULTI_POD,
    RULES_SINGLE_POD,
    FemMesh,
    NamedSharding,
    ShardingRules,
    annotate,
    distribute_tree,
    fem_mesh,
    gather_for_use,
    is_dtensor,
    logical_to_spec,
    make_shardings,
    placed_like,
    reduce_from_shards,
    replicated,
    reset_collectives,
    resolve_fem_mesh,
    shard_leaves,
    sharded_zeros,
    spec_to_placements,
    to_shard,
    use_rules,
)
