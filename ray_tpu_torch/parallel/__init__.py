"""Parallelism: device meshes, logical-axis shardings, process groups, the
ZeRO-3 gather of the sharded training step (`fsdp`) and tensor
parallelism's collectives (`tensor`)."""

from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    make_hybrid_mesh,
    make_mesh,
    make_virtual_mesh,
    AxisRules,
    DEFAULT_RULES,
    logical_sharding,
    shard_pytree,
)
from ray_tpu_torch.parallel.distributed import (
    initialize_from_session,
    initialize_group,
    shutdown_group,
)

__all__ = ["AxisRules", "DEFAULT_RULES", "MeshConfig", "initialize_from_session",
           "initialize_group", "logical_sharding", "make_hybrid_mesh",
           "make_mesh", "make_virtual_mesh", "shard_pytree", "shutdown_group"]
