"""The data mesh (port of ``photon_ml_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` with one ``data`` axis
over its devices; the objective's partial sums meet in one ``psum`` over
it. Here a mesh is an ordered tuple of ``torch.device``s, one per row
shard: shard i's rows live on ``mesh[i]``, and ``ShardedGLMObjective``
(``parallel/distributed.py``) sums the shards' partials in that order. A
device may appear more than once, so one card can hold several shards:
the reference's tests do the same with 8 virtual CPU devices, and on a
one-card machine it is the only way to run more than one shard.

A mesh that spans processes is a ``ProcessMesh``: each of P processes
holds L local shards, each on one of its devices, and global shard s =
rank × L + i. Rows (and a random-effect bucket's entity lanes) split over
the P·L global shards in order, with counts derived from the row (lane)
count and P·L alone, so P processes × L shards hold exactly the shards of
one process × P·L (``shard_extent``). A plain tuple is the one-process
case (``as_process_mesh``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

Mesh = tuple[torch.device, ...]


@dataclass(frozen=True)
class ProcessMesh:
    """The data mesh of every process: this process holds the global shards
    ``first_shard`` .. ``first_shard + len(local) - 1``, shard
    ``first_shard + i`` on ``local[i]``."""

    local: Mesh
    process_index: int = 0
    process_count: int = 1

    @property
    def num_shards(self) -> int:
        """P·L: the global shard count."""
        return self.process_count * len(self.local)

    @property
    def first_shard(self) -> int:
        return self.process_index * len(self.local)

    @property
    def head(self) -> torch.device:
        """The device of this process's first shard, where the descent's
        (n,) vectors and the solver states live."""
        return self.local[0]

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    def global_shards(self) -> range:
        return range(self.first_shard, self.first_shard + len(self.local))


def as_process_mesh(mesh) -> ProcessMesh:
    """A ``ProcessMesh`` as itself, a one-process tuple mesh as the
    ``ProcessMesh`` of one process."""
    if isinstance(mesh, ProcessMesh):
        return mesh
    return ProcessMesh(local=tuple(torch.device(d) for d in mesh))


def effective_mesh(mesh) -> ProcessMesh:
    """``mesh`` over the current process group: after a degrade
    (``multihost.set_degraded_group``) this process's rank among the
    survivors and their count, so rows and buckets split over the
    survivors' shards alone."""
    from photon_ml_tpu_torch.parallel.multihost import process_count, process_index

    pm = as_process_mesh(mesh)
    return ProcessMesh(local=pm.local, process_index=process_index(), process_count=process_count())


def shard_extent(count: int, num_shards: int) -> int:
    """Rows (or lanes) a global shard holds: ceil(count / num_shards); shard
    s holds [s × extent, (s + 1) × extent), the tail padded."""
    return max(-(-count // num_shards), 1)


def process_mesh(local_shards: int | None = None, devices=None) -> ProcessMesh:
    """The mesh of every process in the group (one process without a group):
    ``local_shards`` shards on this process, round-robin over ``devices``
    (every local card unless the caller names others; one shard per
    device when ``local_shards`` is None). Raises without CUDA unless
    ``devices`` is given, as ``data_mesh`` does."""
    import numpy as np

    from photon_ml_tpu_torch.parallel.multihost import allgather_host, process_count, process_index

    mesh = ProcessMesh(local=data_mesh(local_shards, devices), process_index=process_index(),
                       process_count=process_count())
    if mesh.spans_processes:
        counts = allgather_host(np.asarray([len(mesh.local)], np.int64)).ravel()
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"every process must hold as many shards; they hold {counts.tolist()}")
    return mesh


def local_device_count() -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def data_mesh(num_shards: int | None = None, devices=None) -> Mesh:
    """``num_shards`` row shards placed round-robin over ``devices`` (every
    local card unless the caller names others, e.g. ``["cpu"]``); one shard
    per device when ``num_shards`` is None. Raises without CUDA unless
    ``devices`` is given: the mesh never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(local_device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a data mesh needs at least one device")
    k = len(devs) if num_shards is None else int(num_shards)
    if k < 1:
        raise ValueError(f"num_shards must be positive, got {k}")
    return tuple(devs[i % len(devs)] for i in range(k))
