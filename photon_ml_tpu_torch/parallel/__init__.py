"""Data-parallel training across row shards and processes (port of
``photon_ml_tpu/parallel``): the data mesh (one process's, or a
process-spanning ``ProcessMesh``), the sharded objective and its trainer,
and the multi-process runtime's host collectives."""

from photon_ml_tpu_torch.parallel.distributed import (
    DistributedTrainer,
    ShardedGLMObjective,
    shard_batch,
    sharded_minimize,
    sharded_objective,
)
from photon_ml_tpu_torch.parallel.mesh import ProcessMesh, data_mesh, local_device_count, process_mesh

__all__ = [
    "DistributedTrainer",
    "ProcessMesh",
    "ShardedGLMObjective",
    "data_mesh",
    "local_device_count",
    "process_mesh",
    "shard_batch",
    "sharded_minimize",
    "sharded_objective",
]
