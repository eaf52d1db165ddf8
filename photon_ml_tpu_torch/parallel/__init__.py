"""Data-parallel training across row shards and processes (port of
``photon_ml_tpu/parallel``): the data mesh (one process's, or a
process-spanning ``ProcessMesh``), the sharded objective and its trainer,
the multi-process runtime's host collectives, and the skew-aware
placement of entity-sharded random effects."""

from photon_ml_tpu_torch.parallel.distributed import (
    DistributedTrainer,
    ShardedGLMObjective,
    shard_batch,
    sharded_minimize,
    sharded_objective,
)
from photon_ml_tpu_torch.parallel.mesh import ProcessMesh, data_mesh, local_device_count, process_mesh
from photon_ml_tpu_torch.parallel.multihost import host_shard_of_paths, initialize_multihost
from photon_ml_tpu_torch.parallel.placement import (
    PlacementPlan,
    plan_entity_placement,
    plan_shard_placement,
    re_shard_enabled,
)

__all__ = [
    "DistributedTrainer",
    "PlacementPlan",
    "ProcessMesh",
    "ShardedGLMObjective",
    "data_mesh",
    "host_shard_of_paths",
    "initialize_multihost",
    "local_device_count",
    "plan_entity_placement",
    "plan_shard_placement",
    "process_mesh",
    "re_shard_enabled",
    "shard_batch",
    "sharded_minimize",
    "sharded_objective",
]
