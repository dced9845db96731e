"""Distribution: sharding rules for DP/TP/EP/FSDP over the production mesh,
and their placement as DTensors (the port of ``repro.parallel``)."""

from .sharding import (
    P,
    AbstractMesh,
    ShardingConfig,
    batch_specs,
    cache_specs,
    data_axes,
    distribute,
    distribute_tensor,
    local_shape,
    param_specs,
    placements,
    sanitize,
)

__all__ = [
    "P", "AbstractMesh", "ShardingConfig", "param_specs", "batch_specs",
    "cache_specs", "data_axes", "sanitize", "placements", "distribute",
    "distribute_tensor", "local_shape",
]
