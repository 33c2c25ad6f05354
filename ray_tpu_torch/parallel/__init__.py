from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshSpec,
    ShardingRules,
    batch_sharding,
    batch_spec,
    global_to_host_local,
    host_local_to_global,
    replicated,
    shard_params,
)

__all__ = [
    "AXIS_ORDER",
    "MeshSpec",
    "ShardingRules",
    "batch_sharding",
    "batch_spec",
    "global_to_host_local",
    "host_local_to_global",
    "replicated",
    "shard_params",
]
