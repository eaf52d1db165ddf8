"""Data-parallel training across row shards and processes (port of
``photon_ml_tpu/parallel``): the data mesh, the sharded objective and its
trainer, and the multi-process runtime's host collectives."""

from photon_ml_tpu_torch.parallel.distributed import (
    DistributedTrainer,
    ShardedGLMObjective,
    shard_batch,
    sharded_minimize,
    sharded_objective,
)
from photon_ml_tpu_torch.parallel.mesh import data_mesh, local_device_count

__all__ = [
    "DistributedTrainer",
    "ShardedGLMObjective",
    "data_mesh",
    "local_device_count",
    "shard_batch",
    "sharded_minimize",
    "sharded_objective",
]
