"""The multi-process runtime and its host collectives (port of the GLM
subset of ``photon_ml_tpu/parallel/multihost.py``).

Every process runs the same program; ``initialize_multihost`` joins them
into one ``torch.distributed`` process group, each process reads its own
slice of the input files (``host_shard_of_paths``), and the streamed
objective sums its per-process partial values and gradients with
``allreduce_sum_host``: the treeAggregate of Photon ML's
``DistributedGLMLossFunction``. Exactly one process writes shared
outputs (``is_output_process``).

The backend is gloo, chosen here and nowhere switched. Every collective of
this module is a host collective over numpy arrays, as the reference's
are, and gloo runs several processes on one card, which NCCL refuses.
NCCL comes with the first collective over device tensors.

Each collective is an ``all_gather`` of the raw bytes of every process's
arrays, reduced on every process in rank order by the same numpy code, so
all processes hold identical bytes afterwards and their host control flow
(line searches, stopping tests) stays in lock step. Every process must
call each collective at the same program point.

Usage (the same command on every process; the reference's variables, so
one launcher drives either package):

    JAX_COORDINATOR_ADDRESS=host0:29500 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \\
        python -m photon_ml_tpu_torch.cli.train_glm ... --multihost
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKEND = "gloo"
# seconds a collective waits for the other processes before it raises
DEFAULT_TIMEOUT_S = 600.0

# seconds, calls and bytes gathered by the host collectives since the last
# ``reset_collective_stats``
collective_stats: dict = {"seconds": 0.0, "calls": 0, "bytes": 0}


def reset_collective_stats() -> None:
    collective_stats.update(seconds=0.0, calls=0, bytes=0)


def _init_error(detail: str) -> RuntimeError:
    return RuntimeError(
        "multihost initialization failed — on non-auto-detected "
        "clusters set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and "
        "JAX_PROCESS_ID (or pass them explicitly); on a single host, "
        f"drop --multihost. Underlying error: {detail}"
    )


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Join this process into the process group: a gloo group over TCP at
    ``coordinator_address`` (``host:port``, process 0 listens there). The
    arguments default to the reference's variables
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``; a missing or bad one raises the reference's error.
    Collectives wait ``timeout_s`` for the other processes. Returns
    ``runtime_summary()``."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    try:
        if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
            num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        if process_id is None and os.environ.get("JAX_PROCESS_ID"):
            process_id = int(os.environ["JAX_PROCESS_ID"])
    except ValueError as e:
        raise _init_error(str(e)) from e
    missing = [name for name, v in (("coordinator address", coordinator_address),
                                    ("process count", num_processes), ("process id", process_id))
               if v is None]
    if missing:
        raise _init_error(f"no {', '.join(missing)} given")
    if not 0 <= process_id < num_processes:
        raise _init_error(f"process id {process_id} outside [0, {num_processes})")
    if dist.is_initialized():
        raise _init_error("this process already belongs to a process group")
    try:
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, timeout=timedelta(seconds=timeout_s),
        )
    except (ValueError, RuntimeError) as e:
        raise _init_error(str(e)) from e
    return runtime_summary()


def shutdown_multihost() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def runtime_summary() -> dict:
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": torch.cuda.device_count(),
        "backend": BACKEND if dist.is_initialized() else None,
    }


def host_shard_of_paths(paths: Sequence[str]) -> list[str]:
    """The input files this process reads: a round-robin slice of the
    sorted paths by process index. Every path must be visible to every
    process; each is read by one."""
    return sorted(paths)[process_index()::process_count()]


def is_output_process() -> bool:
    """True on the one process that writes shared outputs (models,
    metrics, checkpoints): all processes compute, one writes."""
    return process_index() == 0


# per-call barrier counter: every process calls sync_processes at the same
# program points in the same order, so the counters agree
_BARRIER_SEQ = [0]


def sync_processes(tag: str = "photon-ml-barrier") -> None:
    """Barrier across all processes (a no-op on one). Every process sends
    ``{tag}#{n}``, n its call count; a process that reaches another
    barrier than the rest raises instead of pairing with the wrong one."""
    if process_count() <= 1:
        return
    _BARRIER_SEQ[0] += 1
    key = f"{tag}#{_BARRIER_SEQ[0]}"
    keys = _gather_bytes(key.encode())
    if any(k != keys[0] for k in keys):
        raise RuntimeError(f"processes reached different barriers: {[k.decode() for k in keys]}")


def _gather_bytes(payload: bytes) -> list[bytes]:
    """Every process's ``payload`` in rank order (two all_gathers: the
    sizes, then the bytes padded to the largest)."""
    t0 = time.perf_counter()
    p = process_count()
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(p)]
    dist.all_gather(sizes, size)
    width = max(int(s) for s in sizes)
    buf = torch.zeros(max(width, 1), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(p)]
    dist.all_gather(outs, buf)
    collective_stats["seconds"] += time.perf_counter() - t0
    collective_stats["calls"] += 1
    collective_stats["bytes"] += p * buf.numel()
    return [bytes(o[: int(s)].numpy()) for o, s in zip(outs, sizes)]


def _gather_arrays(arrays: Sequence[np.ndarray]) -> list[list[np.ndarray]]:
    """Every process's ``arrays`` (same count, shapes and dtypes on every
    process) in rank order, moved in one gather of their bytes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    payload = b"".join(a.tobytes() for a in arrays)
    out = []
    for blob in _gather_bytes(payload):
        if len(blob) != len(payload):
            raise RuntimeError("host collective over arrays of different sizes across processes")
        parts, pos = [], 0
        for a in arrays:
            parts.append(np.frombuffer(blob, dtype=a.dtype, count=a.size, offset=pos).reshape(a.shape))
            pos += a.nbytes
        out.append(parts)
    return out


def allgather_host(array: np.ndarray) -> np.ndarray:
    """One same-shape host array from every process, stacked in rank
    order: (P, ...). ``array[None]`` on one process."""
    array = np.asarray(array)
    if process_count() <= 1:
        return array[None]
    return np.stack([g[0] for g in _gather_arrays([array])])


def _reduce(arrays, op):
    if process_count() <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    gathered = _gather_arrays([np.asarray(a, np.float64) for a in arrays])
    out = tuple(op(np.stack([g[i] for g in gathered]), axis=0) for i in range(len(arrays)))
    return out if len(out) > 1 else out[0]


def allreduce_sum_host(*arrays: np.ndarray):
    """Sum numpy arrays across all processes (returned unchanged on one):
    each array is gathered as float64 and summed in rank order, so every
    process receives identical bytes. One array in, one out; several in,
    a tuple out. The streamed objective's per-process partial sums meet
    here: the treeAggregate of the out-of-core path."""
    return _reduce(arrays, np.sum)


def allreduce_max_host(*arrays: np.ndarray):
    """Elementwise max across all processes in float64 (unchanged on one
    process): the streamed summary's min / max statistics (a min rides as
    the max of its negation)."""
    return _reduce(arrays, np.max)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def broadcast_from_host0(tree):
    """Process 0's value of ``tree`` (numpy leaves in nested tuples, lists
    and dicts) on every process; the tree itself on one process. Process
    0 decides what the others adopt, e.g. the checkpoint state only it
    reads."""
    if process_count() <= 1:
        return tree
    blobs = _gather_bytes(pickle.dumps(tree) if process_index() == 0 else b"")
    return _tree_map(np.asarray, pickle.loads(blobs[0]))
