"""Data parallelism across GPUs (counterpart of ``lightning_pose_tpu/parallel``)."""

from lightning_pose_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    devices,
    gather_rows,
    initialize_distributed,
    make_mesh,
    rank,
    replicate,
    shard_rows,
    stream_shard,
    sync_collectives,
    world_size,
)

__all__ = [
    "all_reduce_gradients",
    "devices",
    "gather_rows",
    "initialize_distributed",
    "make_mesh",
    "rank",
    "replicate",
    "shard_rows",
    "stream_shard",
    "sync_collectives",
    "world_size",
]
