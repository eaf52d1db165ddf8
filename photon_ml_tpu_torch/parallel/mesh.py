"""The data mesh (port of ``photon_ml_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` with one ``data`` axis
over its devices; the objective's partial sums meet in one ``psum`` over
it. Here a mesh is an ordered tuple of ``torch.device``s, one per row
shard: shard i's rows live on ``mesh[i]``, and ``ShardedGLMObjective``
(``parallel/distributed.py``) sums the shards' partials in that order. A
device may appear more than once, so one card can hold several shards:
the reference's tests do the same with 8 virtual CPU devices, and on a
one-card machine it is the only way to run more than one shard.
"""

from __future__ import annotations

import torch

Mesh = tuple[torch.device, ...]


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
