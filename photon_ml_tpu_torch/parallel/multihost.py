"""The multi-process runtime and its host collectives (port of the
in-memory subset of ``photon_ml_tpu/parallel/multihost.py``).

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

``exchange_rows`` is the entity-row shuffle: each row travels to one
destination process only, sized exactly (the (P, P) count matrix is
exchanged first, so no block pads to the largest). ``allgather_rows``
concatenates every process's rows in rank order: the multi-process GAME
descent assembles each coordinate's (n,) scores with it.
``allgather_row_chunks`` does the same in bounded rounds, so the
out-of-core trainer's one writer gathers global columns without any
process holding more than a round of them at once.

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

from photon_ml_tpu_torch.obs import devcost

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


def require_process_group() -> None:
    """Raise the initialization error unless this process belongs to a
    process group: a multi-process entry point never runs alone by
    accident."""
    if not dist.is_initialized():
        raise _init_error("this process belongs to no process group (call initialize_multihost first)")


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


def _gather_objects(obj) -> list:
    """Every process's picklable ``obj`` in rank order (one gather)."""
    if process_count() <= 1:
        return [obj]
    return [pickle.loads(b) for b in _gather_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))]


def allgather_rows(*arrays: np.ndarray):
    """Every process's rows of each array concatenated in rank order; the
    row counts may differ between processes (the trailing shape and dtype
    may not). One array in, one out; several in, a tuple out. The arrays
    themselves on one process. One gather for all of them."""
    arrays = tuple(np.asarray(a) for a in arrays)
    if process_count() > 1:
        per_rank = _gather_objects(arrays)
        arrays = tuple(np.concatenate([r[i] for r in per_rank]) for i in range(len(arrays)))
    return arrays if len(arrays) > 1 else arrays[0]


def allgather_row_chunks(arrays, chunk_rows: int, pad_values=None):
    """Every process's rows of ``arrays`` (a dict of host arrays of one row
    count) in rounds of ``chunk_rows`` rows: each round yields a dict of
    (P, chunk_rows, ...) arrays stacked in rank order, so a receiver keeps
    what it needs and drops the round before the next (peak memory
    O(P · chunk_rows), never the global rows). A process with fewer rows
    pads its rounds with ``pad_values[key]`` (default 0: pick a sentinel
    the receiver can tell apart, e.g. -1 row ids). Every process yields the
    same number of rounds, set by the largest process's row count."""
    pad_values = dict(pad_values or {})
    keys = list(arrays)
    cols = [np.asarray(arrays[k]) for k in keys]
    n_loc = len(cols[0]) if cols else 0
    largest = int(allgather_host(np.asarray([n_loc], np.int64)).max())
    for lo in range(0, largest, chunk_rows):
        chunk = []
        for k, a in zip(keys, cols):
            part = a[min(lo, n_loc):min(lo + chunk_rows, n_loc)]
            if len(part) < chunk_rows:
                fill = np.full((chunk_rows - len(part),) + a.shape[1:], pad_values.get(k, 0), a.dtype)
                part = np.concatenate([part, fill])
            chunk.append(part)
        per_rank = _gather_arrays(chunk) if process_count() > 1 else [chunk]
        yield {k: np.stack([r[i] for r in per_rank]) for i, k in enumerate(keys)}


# what the last ``exchange_rows`` moved (the reference's keys)
LAST_EXCHANGE_STATS: dict = {}


def exchange_rows(arrays, dest: np.ndarray, tag: str = "") -> dict:
    """Deliver row ``i`` of every array to process ``dest[i]``: the
    reference's point-to-point shuffle (a Spark exchange in Photon ML).

    ``arrays`` maps names to numpy arrays of one row count (an empty
    sender passes zero rows of the same trailing shapes and dtypes, and
    takes part). Returns a dict of the rows received, grouped by source
    process in ascending order, each source's rows in their order there.
    The identity on one process. Every process calls it at the same
    program point with the same keys.

    One gloo transport: the (P, P) count matrix is gathered first, so each
    process knows what it receives, then one ``all_to_all`` moves each
    (source, destination) block at its exact size (gloo has no
    uniform-block rule, so nothing pads to the largest block). ``tag``
    names the exchange in errors only. ``LAST_EXCHANGE_STATS`` records
    ``bytes_sent``, ``rows_sent``, ``padded_rows`` (the row slots moved,
    summed over arrays: the payload) and ``transport``. While device-cost
    capture is on, the exchange's bytes are recorded once per size
    (``executable_cost`` label ``multihost.all_to_all``, as the
    reference's all-to-all transport records its program)."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    dest = np.asarray(dest, np.int64).reshape(-1)
    p = process_count()
    if p <= 1:
        LAST_EXCHANGE_STATS.update(bytes_sent=0, rows_sent=len(dest), padded_rows=len(dest),
                                   transport="local")
        return arrays
    keys = sorted(arrays)
    for k in keys:
        if len(arrays[k]) != len(dest):
            raise ValueError(f"exchange {tag!r}: array {k!r} has {len(arrays[k])} rows, dest {len(dest)}")
    if len(dest) and (dest.min() < 0 or dest.max() >= p):
        raise ValueError(f"exchange {tag!r}: destinations outside [0, {p})")
    t0 = time.perf_counter()
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=p).astype(np.int64)
    matrix = allgather_host(counts)  # (source, destination) row counts
    me = process_index()
    row_bytes = [arrays[k].dtype.itemsize * int(np.prod(arrays[k].shape[1:], dtype=np.int64)) for k in keys]
    width = sum(row_bytes)
    starts = np.concatenate([[0], np.cumsum(counts)])
    blocks = []
    for q in range(p):
        rows = order[starts[q]:starts[q + 1]]
        blocks.extend(arrays[k][rows].tobytes() for k in keys)
    send = torch.frombuffer(bytearray(b"".join(blocks)), dtype=torch.uint8) if width and len(dest) \
        else torch.zeros(0, dtype=torch.uint8)
    recv_rows = matrix[:, me]
    recv = torch.empty(int(recv_rows.sum()) * width, dtype=torch.uint8)
    dist.all_to_all_single(recv, send, output_split_sizes=[int(r) * width for r in recv_rows],
                           input_split_sizes=[int(c) * width for c in counts])
    # the exchange's bytes in the run's telemetry, once per (sent, received)
    # size, recorded after the collective: no process waits on another's capture
    devcost.capture("multihost.all_to_all", (send, recv),
                    lambda: {"flops": 0.0, "bytes_accessed": float(send.numel() + recv.numel()),
                             "memory": {"argument_size_in_bytes": send.numel(),
                                        "output_size_in_bytes": recv.numel()}})
    raw = recv.numpy()
    out: dict[str, list[np.ndarray]] = {k: [] for k in keys}
    pos = 0
    for src in range(p):
        n_src = int(recv_rows[src])
        for k, rb in zip(keys, row_bytes):
            a = arrays[k]
            out[k].append(np.frombuffer(raw, dtype=a.dtype, count=n_src * (rb // a.dtype.itemsize),
                                        offset=pos).reshape((n_src,) + a.shape[1:]).copy())
            pos += n_src * rb
    nbytes = int(counts.sum()) * width
    collective_stats["seconds"] += time.perf_counter() - t0
    collective_stats["calls"] += 1
    collective_stats["bytes"] += nbytes
    LAST_EXCHANGE_STATS.update(bytes_sent=nbytes, rows_sent=int(counts.sum()),
                               padded_rows=int(counts.sum()) * len(keys), transport=BACKEND)
    return {k: np.concatenate(v) for k, v in out.items()}
