from .mesh import (
    all_reduce_sum,
    barrier,
    default_backend,
    initialize_distributed,
    launch,
    process_count,
    process_index,
    replicate,
    shard_batch,
    shutdown,
)

__all__ = [
    "all_reduce_sum",
    "barrier",
    "default_backend",
    "initialize_distributed",
    "launch",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shutdown",
]
