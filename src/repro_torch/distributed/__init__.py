"""Sharding rules, the activation policy and the collectives of the
port's sharded bodies (port of ``repro/distributed``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    FSDP_RULES,
    logical_to_spec,
    specs_for_tree,
    named_sharding_tree,
    batch_spec,
    MeshAxes,
    PartitionSpec,
)
