"""The multi-process runtime and its host collectives (port of
``photon_ml_tpu/parallel/multihost.py``).

Every process runs the same program; ``initialize_multihost`` joins them
into one ``torch.distributed`` process group, each process reads its own
slice of the input files (``host_shard_of_paths``), and the streamed
objective sums its per-process partial values and gradients with
``allreduce_sum_host``: the treeAggregate of Photon ML's
``DistributedGLMLossFunction``. Exactly one process writes shared
outputs (``is_output_process``).

Two transports carry the host collectives:

- **gloo**, chosen here and nowhere switched: the default process group's
  ``all_gather`` of the raw bytes of every process's arrays, reduced on
  every process in rank order by the same numpy code, so all processes
  hold identical bytes afterwards and their host control flow (line
  searches, stopping tests) stays in lock step. Gloo runs several
  processes on one card, which NCCL refuses.
- **the framed peer-to-peer mesh** (the reference's): one TCP connection
  per ordered pair of processes, each frame an 8-byte length prefix, the
  payload and (``PHOTON_P2P_CRC=1``, negotiated per link) a CRC32 trailer.
  It carries the overlapped exchanges (``exchange_rows_async``), the
  owner-segment collectives (``allgather_obj_p2p``: the random-effect
  combine, the feature-range gather), the skewed ``exchange_rows`` and,
  once a peer is lost, every collective of the surviving group.

``exchange_rows`` is the entity-row shuffle: each row travels to one
destination process only. The (P, P) count matrix is gathered first and
picks the transport, as the reference's does: the mesh when P²·(largest
block) > 2 × payload (entity skew), else one exact-size gloo
``all_to_all``. ``allgather_rows`` concatenates every process's rows in
rank order; ``allgather_row_chunks`` does the same in bounded rounds.

Faults and recovery (ROADMAP 12d-v-a). ``PHOTON_P2P_RETRIES`` > 0 arms the
reliable mode: a mesh exchange ends with a completion ACK on every link
and a failed one is retried through a teardown and rebuild from the
cached addresses, with backoff; retries exhausted against an unreachable
peer harden into ``PeerLost``, and so does a failed gloo collective (a
dead peer closes gloo's pairs). The caller with a recovery path (the
streamed trainer, the in-memory descent under ``PHOTON_DESCENT_DEGRADE``)
confirms the loss with ``roll_call`` over the cached addresses and shrinks
the world with ``set_degraded_group``: from then on ``process_index`` /
``process_count`` are the survivors' ranks, every collective rides the
mesh, and nothing touches the gloo group again (no barrier, no
``new_group``, no ``destroy_process_group``: each can hang on the dead
peer). ``parallel/faults.py`` injects deterministic faults at the framed
send.

Elastic rejoin (``PHOTON_REJOIN=1``). A lost process re-execs, reloads its
original index and every process's mesh address from the mesh cache that
the first address gather wrote (``PHOTON_MESH_CACHE``; ``bootstrap_rejoin``)
and waits on its recorded address to be invited (``rejoin_wait``). It never
calls ``init_process_group``: a gloo group cannot take back a process. At
a visit boundary the survivors probe the lost addresses
(``probe_rejoiners``), invite whoever answers (``send_rejoin_invites``)
and run one roll call over survivors and rejoiners, its quorum judged by
the current group; the agreed group goes through ``set_degraded_group``
and so runs every collective on the framed ring, also at the full size.

Gloo has no heartbeat. ``PHOTON_COORD_MAX_MISSING_HEARTBEATS`` (strict int,
at least 1; unset: the ``timeout_s`` argument) counts 10 s heartbeats, as
the reference's coordination service does: the gloo group's collective
timeout becomes that many times 10 s. A dead peer closes its pairs, which
fails a collective at once; the timeout decides only when a live but silent
peer is given up, so an elastic fleet raises it and lets the roll call, not
gloo, decide who is dead.

Usage (the same command on every process; the reference's variables, so
one launcher drives either package):

    JAX_COORDINATOR_ADDRESS=host0:29500 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \\
        python -m photon_ml_tpu_torch.cli.train_glm ... --multihost
"""

from __future__ import annotations

import io
import json
import logging
import os
import pickle
import selectors
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.obs import devcost
from photon_ml_tpu_torch.obs import sink as _sink
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.spans import emit_event
from photon_ml_tpu_torch.parallel import faults

BACKEND = "gloo"
# seconds a collective waits for the other processes before it raises
DEFAULT_TIMEOUT_S = 600.0
# one heartbeat of PHOTON_COORD_MAX_MISSING_HEARTBEATS, in seconds
HEARTBEAT_S = 10.0

_log = logging.getLogger(__name__)

# the process group's collective timeout
_TIMEOUT_S = [DEFAULT_TIMEOUT_S]
# the coordinator's address as given to initialize_multihost
_COORDINATOR = [""]

# seconds, calls and bytes gathered by the host collectives since the last
# ``reset_collective_stats``; ``_count_collective`` adds under the lock
collective_stats: dict = {"seconds": 0.0, "calls": 0, "bytes": 0}
_STATS_LOCK = threading.Lock()


def reset_collective_stats() -> None:
    with _STATS_LOCK:
        collective_stats.update(seconds=0.0, calls=0, bytes=0)


def _count_collective(t0: float, nbytes: int) -> None:
    """Book one host collective begun at ``t0`` (``time.perf_counter``)
    that moved ``nbytes``: a read-modify-write of process-wide books, so
    under the lock, where a second thread's booking loses no update."""
    with _STATS_LOCK:
        collective_stats["seconds"] += time.perf_counter() - t0
        collective_stats["calls"] += 1
        collective_stats["bytes"] += nbytes


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
    Collectives wait ``timeout_s`` for the other processes. With
    ``PHOTON_P2P_RETRIES`` > 0 every process's mesh address is gathered
    here, while the group is whole, so a roll call after a loss needs no
    gloo collective. ``PHOTON_COORD_MAX_MISSING_HEARTBEATS`` replaces
    ``timeout_s`` by that many 10 s heartbeats (module docstring). Returns
    ``runtime_summary()``."""
    heartbeats = coord_max_missing_heartbeats()  # a typo'd knob names itself, outside the init error
    if heartbeats is not None:
        timeout_s = heartbeats * HEARTBEAT_S
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
    # lint: waive(conc-unlocked-mutation) set once at init, before any exchange worker
    _TIMEOUT_S[0] = float(timeout_s)
    try:
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, timeout=timedelta(seconds=timeout_s),
        )
    except (ValueError, RuntimeError) as e:
        raise _init_error(str(e)) from e
    # lint: waive(conc-unlocked-mutation) set once at init, before any exchange worker
    _COORDINATOR[0] = str(coordinator_address)
    if num_processes > 1 and _p2p_retries() > 0:
        _bootstrap_link_addrs()
    return runtime_summary()


def coord_max_missing_heartbeats() -> int | None:
    """``PHOTON_COORD_MAX_MISSING_HEARTBEATS`` (strict int parse, at least
    1; None unset): the gloo group's timeout in 10 s heartbeats."""
    env = os.environ.get("PHOTON_COORD_MAX_MISSING_HEARTBEATS")
    if env is None or env == "":
        return None
    value = int(env)
    if value < 1:
        raise ValueError(f"PHOTON_COORD_MAX_MISSING_HEARTBEATS must be at least 1, got {env!r}")
    return value


def shutdown_multihost() -> None:
    """Leave the process group (a no-op outside one). A whole group drains
    the exchange worker, closes the mesh and destroys the gloo group; a
    degraded one (and a rejoined process, which holds no gloo group) only
    forgets its pending exchanges and closes the mesh, and returns at once:
    the gloo group holds a dead peer, and destroying it can wait on that
    peer forever."""
    global _DEGRADED, _HOST_ADDRS
    if not dist.is_initialized() and _REJOIN_IDENTITY is None:
        return
    if _DEGRADED is not None:
        reset_async_exchanges()
        _reset_host_links()
        return
    _stop_exchange_worker()
    _reset_host_links()
    _HOST_ADDRS = None
    dist.destroy_process_group()


# a rejoined process's original identity (``bootstrap_rejoin``): its fresh
# interpreter holds no gloo group, so every identity read of this module
# goes through ``_self_pid`` / ``_world_size``, which answer with it. None
# on every process that joined the group with ``initialize_multihost``.
_REJOIN_IDENTITY: dict | None = None


def rejoin_identity() -> dict | None:
    return _REJOIN_IDENTITY


def _self_pid() -> int:
    """This process's original index in the group it joined (kept across
    a rejoin's re-exec)."""
    if _REJOIN_IDENTITY is not None:
        return int(_REJOIN_IDENTITY["pid"])
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    """The original group's size (kept across a rejoin's re-exec)."""
    if _REJOIN_IDENTITY is not None:
        return int(_REJOIN_IDENTITY["world"])
    return dist.get_world_size() if dist.is_initialized() else 1


def original_process_index() -> int:
    return _self_pid()


def original_process_count() -> int:
    return _world_size()


def process_index() -> int:
    """This process's rank in the current group: its original index, or
    its rank among the survivors once the group is degraded."""
    return effective_process_index()


def process_count() -> int:
    """The current group's size (the survivors' once degraded)."""
    return effective_process_count()


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
    accident. A rejoined process (``bootstrap_rejoin``) belongs to its
    group through the mesh."""
    if not dist.is_initialized() and _REJOIN_IDENTITY is None:
        raise _init_error("this process belongs to no process group (call initialize_multihost first)")


def is_output_process() -> bool:
    """True on the one process that writes shared outputs (models,
    metrics, checkpoints): all processes compute, one writes. In a
    degraded group the lowest surviving process writes."""
    return effective_process_index() == 0


# -- gloo, and its hardening into PeerLost -------------------------------------


def _gloo(fn, tag: str):
    """Run one gloo collective. A gloo failure (a dead peer closes its
    pairs: a ``RuntimeError``, not an ``OSError``) hardens into
    ``PeerLost`` when the reliable mode is armed (``PHOTON_P2P_RETRIES`` >
    0), so the caller's recovery path runs the roll call; with the knob
    unset it propagates raw, as before."""
    try:
        return fn()
    except RuntimeError as e:
        if _p2p_retries() > 0:
            raise PeerLost(-1, f"gloo collective {tag!r} failed: {e}") from e
        raise


# per-call barrier counter: every process calls sync_processes at the same
# program points in the same order, so the counters agree
_BARRIER_SEQ = [0]


def sync_processes(tag: str = "photon-ml-barrier") -> None:
    """Barrier across all processes (a no-op on one). Every process sends
    ``{tag}#{n}``, n its call count; a process that reaches another
    barrier than the rest raises instead of pairing with the wrong one."""
    if process_count() <= 1:
        return
    # lint: waive(conc-unlocked-mutation) barriers run on the calling thread only
    _BARRIER_SEQ[0] += 1
    key = f"{tag}#{_BARRIER_SEQ[0]}"
    keys = _gather_bytes(key.encode(), tag="barrier")
    if any(k != keys[0] for k in keys):
        raise RuntimeError(f"processes reached different barriers: {[k.decode() for k in keys]}")


def _gather_bytes(payload: bytes, group=None, tag: str = "host_collective") -> list[bytes]:
    """Every process's ``payload`` in rank order (two all_gathers: the
    sizes, then the bytes padded to the largest; on the mesh once the
    group is degraded). ``collective_stats`` counts the calls."""
    t0 = time.perf_counter()
    p = process_count()
    if _DEGRADED is not None:
        out = [np.asarray(v).tobytes() for v in _p2p_allgather_obj(np.frombuffer(payload, np.uint8), tag=tag)]
        _count_collective(t0, sum(len(b) for b in out))
        return out
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(p)]
    _gloo(lambda: dist.all_gather(sizes, size, group=group), tag)
    width = max(int(s) for s in sizes)
    buf = torch.zeros(max(width, 1), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(p)]
    _gloo(lambda: dist.all_gather(outs, buf, group=group), tag)
    _count_collective(t0, p * buf.numel())
    return [bytes(o[: int(s)].numpy()) for o, s in zip(outs, sizes)]


def _gather_arrays(arrays: Sequence[np.ndarray], group=None, tag: str = "host_collective") -> list[list[np.ndarray]]:
    """Every process's ``arrays`` (same count, shapes and dtypes on every
    process) in rank order, moved in one gather of their bytes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    payload = b"".join(a.tobytes() for a in arrays)
    out = []
    for blob in _gather_bytes(payload, group, tag):
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
    return np.stack([g[0] for g in _gather_arrays([array], tag="allgather_host")])


def _gather_same(arrays: Sequence[np.ndarray], group=None, tag: str = "host_collective") -> list[list[np.ndarray]]:
    """``_gather_arrays`` for callers whose every process passes the same
    count, shapes and dtypes by construction (lock-step collectives): one
    all_gather of the bytes, without the exchange of sizes first."""
    if _DEGRADED is not None:
        return [[a.copy() for a in g] for g in _gather_arrays(arrays, group, tag)]
    t0 = time.perf_counter()
    arrays = [np.ascontiguousarray(a) for a in arrays]
    payload = b"".join(a.tobytes() for a in arrays)
    buf = torch.zeros(max(len(payload), 1), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(process_count())]
    _gloo(lambda: dist.all_gather(outs, buf, group=group), tag)
    _count_collective(t0, len(outs) * buf.numel())
    out = []
    for o in outs:
        blob, parts, pos = o.numpy(), [], 0
        for a in arrays:
            parts.append(np.frombuffer(blob, dtype=a.dtype, count=a.size, offset=pos).reshape(a.shape).copy())
            pos += a.nbytes
        out.append(parts)
    return out


def _reduce(arrays, op, wire_dtype=np.float64, gather=_gather_arrays, tag: str = "host_collective"):
    if process_count() <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    gathered = gather([np.asarray(a, wire_dtype) for a in arrays], tag=tag)
    out = tuple(op(np.stack([g[i] for g in gathered]).astype(np.float64, copy=False), axis=0)
                for i in range(len(arrays)))
    return out if len(out) > 1 else out[0]


def allreduce_sum_host(*arrays: np.ndarray):
    """Sum numpy arrays across all processes (returned unchanged on one):
    each array is gathered as float64 and summed in rank order, so every
    process receives identical bytes. One array in, one out; several in,
    a tuple out. The streamed objective's per-process partial sums meet
    here: the treeAggregate of the out-of-core path."""
    return _reduce(arrays, np.sum, tag="allreduce_sum")


def allreduce_sum_lockstep(*arrays: np.ndarray, wire_dtype=np.float64):
    """``allreduce_sum_host`` for arrays of the same shapes on every process
    by construction (the feature-range-sharded objective's margins and
    scalars): one all_gather instead of two, each array on the wire as
    ``wire_dtype`` (float32 partials lose nothing on a float32 wire, at
    half the bytes), summed in float64 in rank order."""
    return _reduce(arrays, np.sum, wire_dtype, _gather_same, tag="allreduce_sum")


def allgather_concat(array: np.ndarray) -> np.ndarray:
    """Every process's 1-D ``array`` (one dtype everywhere, lengths free)
    concatenated in rank order: the feature-range gather, over the mesh
    (``allgather_obj_p2p``, tag ``fe_gather``, as the reference's rides
    it), counted in ``collective_stats``. Data movement only, so the
    result holds each process's bytes as they were. ``array`` itself on
    one process."""
    array = np.ascontiguousarray(array)
    if process_count() <= 1:
        return array
    t0 = time.perf_counter()
    out = np.concatenate([np.asarray(p) for p in allgather_obj_p2p(array, tag="fe_gather")])
    _count_collective(t0, out.nbytes)
    return out


def allreduce_max_host(*arrays: np.ndarray):
    """Elementwise max across all processes in float64 (unchanged on one
    process): the streamed summary's min / max statistics (a min rides as
    the max of its negation)."""
    return _reduce(arrays, np.max, tag="allreduce_max")


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
    reads. In a degraded group "process 0" is the lowest survivor."""
    if process_count() <= 1:
        return tree
    blobs = _gather_bytes(pickle.dumps(tree) if process_index() == 0 else b"", tag="broadcast0")
    return _tree_map(np.asarray, pickle.loads(blobs[0]))


def _gather_objects(obj, tag: str = "host_collective") -> list:
    """Every process's picklable ``obj`` in rank order (one gather)."""
    if process_count() <= 1:
        return [obj]
    return [pickle.loads(b) for b in _gather_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), tag=tag)]


def allgather_rows(*arrays: np.ndarray):
    """Every process's rows of each array concatenated in rank order; the
    row counts may differ between processes (the trailing shape and dtype
    may not). One array in, one out; several in, a tuple out. The arrays
    themselves on one process. One gather for all of them."""
    arrays = tuple(np.asarray(a) for a in arrays)
    if process_count() > 1:
        per_rank = _gather_objects(arrays, tag="allgather_rows")
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
        per_rank = _gather_arrays(chunk, tag="row_chunks") if process_count() > 1 else [chunk]
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

    The (P, P) count matrix is gathered first and picks the transport for
    every process alike, by the reference's rule: the framed mesh
    (``transport`` ``p2p_host``) when P²·(largest block) > 2 × payload, the
    skew at which the reference's uniform-block ``all_to_all`` would pad
    past twice the payload, and always once the group is degraded;
    otherwise one exact-size gloo ``all_to_all`` (``gloo``). ``tag`` names
    the exchange in errors, fault plans and telemetry. ``LAST_EXCHANGE_STATS``
    records ``bytes_sent``, ``rows_sent``, ``padded_rows`` (the row slots
    moved, summed over arrays: the payload) and ``transport``. While
    device-cost capture is on, a gloo exchange's bytes are recorded once
    per size (``executable_cost`` label ``multihost.all_to_all``)."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    dest = np.asarray(dest, np.int64).reshape(-1)
    p = process_count()
    if p <= 1:
        LAST_EXCHANGE_STATS.update(bytes_sent=0, rows_sent=len(dest), padded_rows=len(dest),
                                   transport="local")
        return arrays
    t0 = time.perf_counter()
    keys = sorted(arrays)
    for k in keys:
        if len(arrays[k]) != len(dest):
            raise ValueError(f"exchange {tag!r}: array {k!r} has {len(arrays[k])} rows, dest {len(dest)}")
    if len(dest) and (dest.min() < 0 or dest.max() >= p):
        raise ValueError(f"exchange {tag!r}: destinations outside [0, {p})")
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=p).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    # (source, destination) row counts
    matrix = allgather_host(counts).reshape(p, p)
    maxc = max(int(matrix.max()), 1)
    if _DEGRADED is not None or p * p * maxc > 2 * max(int(matrix.sum()), 1):
        # one socket-use order: never interleave with an exchange on the worker
        drain_async_exchanges()
        stats: dict = {}
        out = _host_p2p_exchange(arrays, order, starts, matrix, tag=tag, stats=stats)
    else:
        out, stats, (send, recv) = _exchange_on(arrays, order, counts, matrix, tag)
        # the exchange's bytes in the run's telemetry, once per (sent, received)
        # size, recorded after the collective: no process waits on another's capture
        devcost.capture("multihost.all_to_all", (send, recv),
                        lambda: {"flops": 0.0, "bytes_accessed": float(send.numel() + recv.numel()),
                                 "memory": {"argument_size_in_bytes": send.numel(),
                                            "output_size_in_bytes": recv.numel()}})
    _count_collective(t0, stats["bytes_sent"])
    LAST_EXCHANGE_STATS.update(stats)
    return out


def _exchange_on(arrays: dict, order: np.ndarray, counts: np.ndarray, matrix: np.ndarray,
                 tag: str) -> tuple[dict, dict, tuple]:
    """``exchange_rows``' gloo transport: (the rows received, the
    exchange's stats, the (send, receive) byte tensors)."""
    p, me = process_count(), process_index()
    keys = sorted(arrays)
    row_bytes = [arrays[k].dtype.itemsize * int(np.prod(arrays[k].shape[1:], dtype=np.int64)) for k in keys]
    width = sum(row_bytes)
    starts = np.concatenate([[0], np.cumsum(counts)])
    blocks = []
    for q in range(p):
        rows = order[starts[q]:starts[q + 1]]
        blocks.extend(arrays[k][rows].tobytes() for k in keys)
    send = torch.frombuffer(bytearray(b"".join(blocks)), dtype=torch.uint8) if width and len(order) \
        else torch.zeros(0, dtype=torch.uint8)
    recv_rows = matrix[:, me]
    recv = torch.empty(int(recv_rows.sum()) * width, dtype=torch.uint8)
    _gloo(lambda: dist.all_to_all_single(recv, send, output_split_sizes=[int(r) * width for r in recv_rows],
                                         input_split_sizes=[int(c) * width for c in counts]), tag)
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
    sent = int(counts.sum())
    stats = dict(bytes_sent=sent * width, rows_sent=sent, padded_rows=sent * len(keys), transport=BACKEND)
    return {k: np.concatenate(v) for k, v in out.items()}, stats, (send, recv)


# ---------------------------------------------------------------------------
# the framed peer-to-peer mesh
# ---------------------------------------------------------------------------

# host-collective payload formats: a 1-byte kind prefix selects the decode.
# PICKLE carries any host object; NDARRAY carries array-bearing payloads as
# the container skeleton (array leaves replaced by position markers) and the
# arrays' (dtype, shape) specs pickled small, then each array's raw bytes,
# so the send side never pickles or copies a row payload. The reference's
# formats byte for byte.
_PAYLOAD_PICKLE = 0
_PAYLOAD_NDARRAY = 1


class _NdRef:
    """Skeleton placeholder for the i-th raw array of an NDARRAY payload."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_NdRef, (self.i,))


# the placeholder's name on the wire: the reference's, so a skeleton's bytes
# are the reference's for the same payload (nothing of the reference is
# imported: the skeleton's pickler writes the name, its unpickler maps it)
_NDREF_WIRE = ("photon_ml_tpu.parallel.multihost", "_NdRef")


class _SkeletonPickler(pickle._Pickler):
    """The pure-Python pickler (the C one's bytes), writing ``_NdRef``
    under its wire name."""

    def save_global(self, obj, name=None):
        if obj is not _NdRef:
            return super().save_global(obj, name)
        self.save(_NDREF_WIRE[0])
        self.save(_NDREF_WIRE[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _SkeletonUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _NDREF_WIRE:
            return _NdRef
        return super().find_class(module, name)


def _dumps_skeleton(obj) -> bytes:
    buf = io.BytesIO()
    _SkeletonPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


def _encode_host_payload(obj) -> tuple[list, int]:
    """``(wire_parts, total_bytes)`` for one host-collective payload: the
    buffers the sender streams in order, arrays as zero-copy views of the
    (contiguous) sources. Only plain ndarrays of simple dtypes take the raw
    path; object and structured dtypes and ndarray subclasses stay pickled
    (in the skeleton, or as a whole PICKLE payload when no array is raw)."""
    arrays: list[np.ndarray] = []
    shapes: list[tuple] = []

    def strip(x):
        if type(x) is np.ndarray and not x.dtype.hasobject and x.dtype.names is None:
            # the original shape: ascontiguousarray makes a 0-d array 1-d
            arrays.append(np.ascontiguousarray(x))
            shapes.append(x.shape)
            return _NdRef(len(arrays) - 1)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [strip(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    skeleton = strip(obj)
    if not arrays:
        raw = bytes([_PAYLOAD_PICKLE]) + pickle.dumps(obj, protocol=4)
        return [raw], len(raw)
    specs = [(a.dtype.str, shape) for a, shape in zip(arrays, shapes)]
    head = _dumps_skeleton((skeleton, specs))
    parts: list = [bytes([_PAYLOAD_NDARRAY]) + struct.pack("!q", len(head)) + head]
    total = len(parts[0])
    for a in arrays:
        if a.size == 0:
            continue  # the spec alone rebuilds an empty array
        m = memoryview(a).cast("B")
        parts.append(m)
        total += len(m)
    return parts, total


def _decode_host_payload(raw: bytes):
    """Inverse of ``_encode_host_payload``; arrays come back as fresh
    writable copies."""
    kind = raw[0]
    body = memoryview(raw)[1:]
    if kind == _PAYLOAD_PICKLE:
        return pickle.loads(body)
    if kind != _PAYLOAD_NDARRAY:
        raise RuntimeError(f"host collective payload: unknown wire format {kind}")
    head_len = struct.unpack("!q", body[:8])[0]
    skeleton, specs = _SkeletonUnpickler(io.BytesIO(body[8:8 + head_len])).load()
    offset = 1 + 8 + head_len
    arrays = []
    for dt, shape in specs:
        dtype = np.dtype(dt)
        count = int(np.prod(shape, dtype=np.int64))
        arrays.append(np.frombuffer(raw, dtype, count=count, offset=offset).reshape(shape).copy())
        offset += count * dtype.itemsize

    def restore(x):
        if isinstance(x, _NdRef):
            return arrays[x.i]
        if isinstance(x, dict):
            return {k: restore(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [restore(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        if isinstance(x, list):
            return [restore(v) for v in x]
        return x

    return restore(skeleton)


# -- knobs ----------------------------------------------------------------------


def _p2p_timeout_s() -> float | None:
    """``PHOTON_P2P_TIMEOUT_S`` (seconds, default 300; 0 or negative:
    blocking sockets): every socket operation of the mesh (accept,
    connect, send, recv) times out, so a dead or silent peer raises
    instead of hanging the exchange."""
    env = os.environ.get("PHOTON_P2P_TIMEOUT_S")
    if env is not None and env != "":
        v = float(env)
        return v if v > 0 else None
    return 300.0


def _configure_link_socket(sock) -> None:
    """The mesh's socket policy: the knob's timeout and TCP_NODELAY (small
    length-prefixed frames must not wait on Nagle)."""
    sock.settimeout(_p2p_timeout_s())
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _p2p_retries() -> int:
    """``PHOTON_P2P_RETRIES`` (default 0: any link error tears the mesh
    down and raises, as before). N > 0 arms the reliable mode: a completion
    ACK ends every framed exchange (so one process's failure fails every
    process's exchange alike), a failed exchange is retried up to N times
    through the teardown and rebuild, with exponential backoff, and gloo
    and ring-collective failures harden into ``PeerLost``."""
    env = os.environ.get("PHOTON_P2P_RETRIES")
    if env is not None and env != "":
        return max(int(env), 0)
    return 0


def _p2p_backoff_s() -> float:
    """``PHOTON_P2P_BACKOFF_S`` (seconds, default 0.5): attempt k sleeps
    ``base * 2**k`` times one plus a jitter fraction in [0, 0.5) derived
    from (process index, attempt), with no random state."""
    env = os.environ.get("PHOTON_P2P_BACKOFF_S")
    if env is not None and env != "":
        return max(float(env), 0.0)
    return 0.5


def _retry_backoff_sleep(attempt: int) -> float:
    base = _p2p_backoff_s()
    if base <= 0.0:
        return 0.0
    pid = _self_pid()
    jitter = ((pid * 2654435761 + attempt * 40503) % 512) / 1024.0
    return base * (2.0 ** attempt) * (1.0 + jitter)


def _p2p_crc_enabled() -> bool:
    """``PHOTON_P2P_CRC`` (default 0): advertise frame protocol v1 (the
    CRC32 trailer) in the mesh hello. A link carries the trailer only when
    both ends advertised it; off, the wire bytes are the plain framing."""
    env = os.environ.get("PHOTON_P2P_CRC")
    if env is not None and env != "":
        return int(env) != 0
    return False


def _p2p_heartbeat_s() -> float | None:
    """``PHOTON_P2P_HEARTBEAT_S`` (seconds, default 5; 0 or negative
    disables): while a framed send or receive is blocked on a silent peer
    and a telemetry sink is on, one ``p2p_heartbeat`` record per interval,
    long before the ``PHOTON_P2P_TIMEOUT_S`` abort."""
    env = os.environ.get("PHOTON_P2P_HEARTBEAT_S")
    if env is not None and env != "":
        v = float(env)
        return v if v > 0 else None
    return 5.0


# frame-protocol versions a process advertises in the mesh hello: 0 =
# length-prefixed frames, 1 = length prefix + payload + CRC32 trailer. The
# hello int packs ``pid | (version << 16)``: version 0 leaves it the pid.
_FRAME_PROTO_CRC = 1


class LinkCorruption(ConnectionError):
    """A framed payload failed its CRC32 check: the frame arrived, its bytes
    are wrong. A transient for the retry layer."""


class PeerUnreachable(ConnectionError):
    """A mesh (re)build could not reach one peer (connect refused or timed
    out, accept never arrived). Transient until the retries run out, then
    it hardens into ``PeerLost``. ``missing``: every peer the build missed
    (``peer`` is the lowest)."""

    def __init__(self, peer: int, message: str, missing: Sequence[int] | None = None):
        super().__init__(message)
        self.peer = peer
        self.missing = [peer] if missing is None else list(missing)


class PeerLost(ConnectionError):
    """The transport has given up on a peer (``peer`` -1 when the failing
    link is unknown). A caller with a recovery path confirms the loss with a
    roll call and degrades; any other gets an abort that names the peer
    instead of a timeout."""

    def __init__(self, peer: int, message: str):
        super().__init__(message)
        self.peer = peer


# -- the degraded group -----------------------------------------------------------
# After a confirmed loss the gloo group is unusable (every collective would
# include, and fail or hang on, the dead process), so recovery shrinks the
# world on the host: a degraded group names the surviving original process
# indices, every collective of this module rides the mesh among them (whose
# addresses are cached: no gloo collective needed), and the effective index
# and count replace the gloo rank and size.

_DEGRADED: dict | None = None


def degraded_group() -> dict | None:
    return _DEGRADED


def effective_process_count() -> int:
    """The current group's size. A rejoined process before its admission
    counts its original group, never a healthy world of one: it runs no
    collective until the rejoin roll call seats it."""
    if _DEGRADED is not None:
        return len(_DEGRADED["survivors"])
    return _world_size()


def effective_process_index() -> int:
    if _DEGRADED is not None:
        return _DEGRADED["rank"]
    return _self_pid()


def effective_topology() -> tuple:
    """The topology this process computes under, as a hashable cache key:
    (backend, local card count, effective process count). A cache keyed on
    it never re-enters state built for the group before a degrade."""
    return ("cuda" if torch.cuda.is_available() else "cpu", torch.cuda.device_count(),
            effective_process_count())


def set_degraded_group(survivors) -> None:
    """Shrink this process's world to ``survivors`` (original process
    indices, this process among them). Tears the mesh down: the next
    exchange rebuilds it over the survivors from the cached addresses. An
    expanded group (a rejoin's) goes through here too and stays on the
    mesh even at the original size: the rejoined process holds no gloo
    group."""
    global _DEGRADED
    survivors = tuple(sorted(int(s) for s in survivors))
    pid = _self_pid()
    if pid not in survivors:
        raise ValueError(f"process {pid} cannot join a degraded group {survivors} that excludes it")
    _reset_host_links()
    if len(survivors) == _world_size() and _DEGRADED is None and _REJOIN_IDENTITY is None:
        return  # the whole group: not degraded
    _DEGRADED = {"survivors": survivors, "rank": survivors.index(pid)}
    REGISTRY.gauge_set("fleet.survivors", float(len(survivors)))
    emit_event("degraded_group", survivors=list(survivors), rank=_DEGRADED["rank"])


def _orig_pid(rank: int) -> int:
    """Effective rank -> original process index."""
    if _DEGRADED is not None:
        return _DEGRADED["survivors"][rank]
    return rank


# -- frames -------------------------------------------------------------------------

# the cached mesh: {"send": {pid: socket}, "recv": {pid: socket}, "proto": {pid: version}}
_HOST_LINKS: dict | None = None

# per-link frame-set counters: every process issues the same exchanges at
# the same program points, so the k-th frame set sent on link i→j is the
# k-th received there, and both ends derive the correlation id
# ``p2p:<src>><dst>#<k>`` with no bytes on the wire; a fault plan's ``seq``
# names it too. Counted whether or not a sink is on.
_LINK_SEQ: dict = {"send": {}, "recv": {}}


def _next_link_seq(direction: str, peer: int) -> int:
    seqs = _LINK_SEQ[direction]
    seqs[peer] = seqs.get(peer, 0) + 1
    return seqs[peer]


def _sink_active() -> bool:
    return _sink.is_active()


def _reset_host_links() -> None:
    """Close every cached mesh socket and forget the mesh, so the next
    exchange rebuilds it. Called on any mesh error: after a partial send or
    receive the framing of the surviving streams is undefined, so the only
    safe state is no mesh. Peers fail fast against the closed sockets on
    their next use and reset too. The frame counters restart with the mesh."""
    global _HOST_LINKS
    links, _HOST_LINKS = _HOST_LINKS, None
    _LINK_SEQ["send"] = {}
    _LINK_SEQ["recv"] = {}
    if not links:
        return
    for side in ("send", "recv"):
        for sock in links.get(side, {}).values():
            _close_quietly(sock)


def _is_loopback(ip: str) -> bool:
    return ip.startswith("127.") or ip in ("0.0.0.0", "localhost", "::1")


def _coordinator_is_loopback(host: str) -> bool:
    """True when the coordinator host is loopback, literally or through
    name resolution (a machine's own hostname often maps to 127.0.1.1)."""
    if not host:
        return False
    if _is_loopback(host):
        return True
    try:
        return _is_loopback(socket.gethostbyname(host))
    # lint: waive(except-swallow) an unresolved name is not loopback
    except OSError:
        return False


def _local_ip() -> str:
    """This host's address as peers dial it: ``PHOTON_EXCHANGE_HOST`` when
    set; 127.0.0.1 when the coordinator is loopback (every process then
    runs on this machine); else the interface that routes toward the
    coordinator (a UDP connect sends no packet), else this hostname's
    address. Unlike the reference it probes no address outside the
    cluster. An address that is still loopback with several processes and
    a remote coordinator fails fast: remote peers would dial themselves."""
    explicit = os.environ.get("PHOTON_EXCHANGE_HOST")
    if explicit:
        return explicit
    target = os.environ.get("JAX_COORDINATOR_ADDRESS") or _COORDINATOR[0]
    host = target.rsplit(":", 1)[0] if target else ""
    if _coordinator_is_loopback(host):
        return "127.0.0.1"
    last = "127.0.0.1"
    if host:
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((host, 53))
                ip = s.getsockname()[0]
            if not _is_loopback(ip):
                return ip
            last = ip
        # lint: waive(except-swallow) falls through to the next address source; loopback-only raises below
        except OSError:
            pass
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not _is_loopback(ip):
            return ip
        last = ip
    # lint: waive(except-swallow) falls through to the next address source; loopback-only raises below
    except OSError:
        pass
    if _world_size() > 1:
        raise RuntimeError(
            f"host exchange address discovery found only loopback {last!r} with process_count="
            f"{_world_size()} and coordinator {host!r}: remote peers cannot dial it. Set "
            "PHOTON_EXCHANGE_HOST to this host's reachable address.")
    return last


def _recv_exact(sock, n: int, peer: int | None = None, tag: str | None = None,
                heartbeat: float | None = None) -> bytes:
    """``n`` bytes from ``sock``. ``heartbeat=None`` (always when no sink is
    on: callers decide once per exchange) is the plain recv loop; with a
    heartbeat the recv polls and emits a ``p2p_heartbeat`` per silent
    interval, the knob's timeout still bounding the silence."""
    if heartbeat is None:
        chunks = []
        while n:
            part = sock.recv(min(n, 1 << 20))
            if not part:
                raise ConnectionError("exchange peer closed the connection")
            chunks.append(part)
            n -= len(part)
        return b"".join(chunks)
    timeout_s = _p2p_timeout_s()
    chunks = []
    silent = 0.0
    with selectors.DefaultSelector() as sel:
        sel.register(sock, selectors.EVENT_READ)
        while n:
            t0 = time.perf_counter()
            if not sel.select(timeout=heartbeat):
                silent += time.perf_counter() - t0
                emit_event("p2p_heartbeat", peer=peer, tag=tag, blocked_s=silent, bytes_remaining=n,
                           direction="recv")
                if timeout_s is not None and silent >= timeout_s:
                    raise socket.timeout(f"exchange recv from process {peer} silent for {silent:.1f}s "
                                         "(PHOTON_P2P_TIMEOUT_S)")
                continue
            part = sock.recv(min(n, 1 << 20))
            if not part:
                raise ConnectionError("exchange peer closed the connection")
            silent = 0.0
            chunks.append(part)
            n -= len(part)
    return b"".join(chunks)


def _sendall_hb(sock, data, peer: int | None = None, tag: str | None = None,
                heartbeat: float | None = None) -> None:
    """``sock.sendall(data)``; with a heartbeat, a send stalled on a full
    buffer toward a wedged peer emits ``p2p_heartbeat`` records
    (``direction: send``) and times out after the knob's silence."""
    if heartbeat is None:
        sock.sendall(data)
        return
    timeout_s = _p2p_timeout_s()
    view = memoryview(data)
    silent = 0.0
    with selectors.DefaultSelector() as sel:
        sel.register(sock, selectors.EVENT_WRITE)
        while view:
            t0 = time.perf_counter()
            if not sel.select(timeout=heartbeat):
                silent += time.perf_counter() - t0
                emit_event("p2p_heartbeat", peer=peer, tag=tag, blocked_s=silent, bytes_remaining=len(view),
                           direction="send")
                if timeout_s is not None and silent >= timeout_s:
                    raise socket.timeout(f"exchange send to process {peer} blocked for {silent:.1f}s "
                                         "(PHOTON_P2P_TIMEOUT_S)")
                continue
            sent = sock.send(view)
            if sent == 0:
                raise ConnectionError("exchange peer closed the connection")
            silent = 0.0
            view = view[sent:]


def _send_frame(sock, payload: bytes, crc: bool, peer: int | None = None, tag: str | None = None,
                heartbeat: float | None = None, corrupt_wire: bool = False) -> None:
    """One frame: the 8-byte length prefix, the payload and, on a CRC link,
    the CRC32 trailer of the payload (the prefix never counts it).
    ``corrupt_wire`` (fault injection) flips a payload byte after the
    trailer is computed."""
    wire = faults._corrupt(payload) if corrupt_wire else payload
    _sendall_hb(sock, struct.pack("!q", len(payload)), peer, tag, heartbeat)
    _sendall_hb(sock, wire, peer, tag, heartbeat)
    if crc:
        _sendall_hb(sock, struct.pack("!I", zlib.crc32(payload)), peer, tag, heartbeat)


def _send_frame_parts(sock, parts: list, total: int, crc: bool, peer: int | None = None,
                      tag: str | None = None, heartbeat: float | None = None,
                      corrupt_wire: bool = False) -> None:
    """``_send_frame`` for a payload in several buffers: one prefix for the
    whole, each part streamed without concatenation, and one trailer over
    the parts (equal to the trailer over their concatenation)."""
    wire = parts
    if corrupt_wire and parts:
        wire = [faults._corrupt(bytes(parts[0])), *parts[1:]]
    _sendall_hb(sock, struct.pack("!q", total), peer, tag, heartbeat)
    for p in wire:
        _sendall_hb(sock, p, peer, tag, heartbeat)
    if crc:
        c = 0
        for p in parts:
            c = zlib.crc32(p, c)
        _sendall_hb(sock, struct.pack("!I", c & 0xFFFFFFFF), peer, tag, heartbeat)


def _recv_frame_payload(sock, n: int, crc: bool, peer: int | None = None, tag: str | None = None,
                        heartbeat: float | None = None) -> bytes:
    """The payload of a frame whose prefix was read, its trailer checked on
    a CRC link (a mismatch raises ``LinkCorruption``)."""
    raw = _recv_exact(sock, n, peer, tag, heartbeat)
    if crc:
        want = struct.unpack("!I", _recv_exact(sock, 4, peer, tag, heartbeat))[0]
        got = zlib.crc32(raw)
        if got != want:
            raise LinkCorruption(f"exchange frame from process {peer} tag {tag!r}: CRC32 mismatch "
                                 f"(got {got:#010x}, trailer {want:#010x})")
    return raw


# the reliable mode's completion ACK: one byte a link an exchange, confirming
# the peer finished its whole exchange
_ACK_BYTE = b"\xa5"

# every process's (ip, port), from the first build (or, with retries armed,
# from initialize_multihost): rebuilds reuse them and re-bind this process's
# recorded port, with no gloo collective, so a rebuild is legal on the
# exchange worker and in a degraded group
_HOST_ADDRS: dict[int, tuple[str, int]] | None = None

# serializes mesh builds across threads
_LINKS_BUILD_LOCK = threading.RLock()


def _hello_int(pid: int) -> int:
    """The mesh hello: the sender's pid, the advertised frame protocol in
    the high bytes (version 0 leaves the int the pid)."""
    proto = _FRAME_PROTO_CRC if _p2p_crc_enabled() else 0
    return pid | (proto << 16)


def _decode_hello(raw: int) -> tuple[int, int]:
    return raw & 0xFFFF, raw >> 16


def _close_quietly(sock) -> None:
    try:
        sock.close()
    # lint: waive(except-swallow) closing is best effort on a torn mesh
    except OSError:  # closing is best effort on a torn mesh
        pass


def _gather_link_addrs(own: tuple[str, int]) -> dict[int, tuple[str, int]]:
    """Every process's (IPv4, port) as five small ints, over gloo: the one
    collective the mesh uses, in program order on the calling thread."""
    p = _world_size()
    ip = np.frombuffer(socket.inet_aton(own[0]), np.uint8).astype(np.int64)
    mine = np.concatenate([ip, [own[1]]]).astype(np.int64)
    addrs = np.stack([g[0] for g in _gather_arrays([mine], tag="link_addrs")]).reshape(p, 5)
    return {q: (socket.inet_ntoa(addrs[q, :4].astype(np.uint8).tobytes()), int(addrs[q, 4])) for q in range(p)}


def _bootstrap_link_addrs() -> None:
    """Record every process's mesh address now (a listener bound once for
    its port, then closed; the builds re-bind it)."""
    global _HOST_ADDRS
    with _LINKS_BUILD_LOCK:
        if _HOST_ADDRS is not None:
            return
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((_local_ip(), 0))
            own = srv.getsockname()[:2]
        finally:
            srv.close()
        _HOST_ADDRS = _gather_link_addrs(own)
        _maybe_persist_mesh_addrs()


def _build_host_links(peers: list[int], timeout_s, srv=None) -> dict:
    """One full-mesh build over ``peers`` (original pids, this process
    among them): every ordered pair gets its own one-way TCP connection, so
    concurrent sends and receives never share a stream. On any partial
    failure the established sockets and the listener close and the acceptor
    thread is joined before the error propagates: a half-built mesh leaks
    nothing into the next attempt. Returns ``{"send": {pid: sock}, "recv":
    {pid: sock}, "proto": {pid: negotiated version}}``."""
    global _HOST_ADDRS
    pid = _self_pid()
    others = [p for p in peers if p != pid]
    first_build = _HOST_ADDRS is None
    if srv is None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.settimeout(timeout_s)  # accept() must not hang on a dead peer
        # the listener binds the address peers dial, never every interface;
        # rebuilds bind the recorded one (peers dial the cached address)
        own = (_local_ip(), 0) if first_build else _HOST_ADDRS[pid]
        try:
            srv.bind(own)
        except OSError:
            srv.close()
            raise
        srv.listen(max(len(peers), 1))
    if first_build:
        try:
            _HOST_ADDRS = _gather_link_addrs(srv.getsockname()[:2])
        except BaseException:
            _HOST_ADDRS = None
            srv.close()
            raise
        _maybe_persist_mesh_addrs()

    recv_socks: dict[int, socket.socket] = {}
    recv_protos: dict[int, int] = {}
    accept_err: list[BaseException] = []
    peer_ips = {_HOST_ADDRS[p][0] for p in others}

    def accept_all():
        try:
            while len(recv_socks) < len(others):
                # only a peer of this build, from the address it published,
                # may open a link (its frames are unpickled): any other
                # connection is dropped before or at its hello
                conn, addr = srv.accept()
                if addr[0] not in peer_ips:
                    _close_quietly(conn)
                    continue
                try:
                    _configure_link_socket(conn)
                    src, proto = _decode_hello(struct.unpack("!i", _recv_exact(conn, 4))[0])
                except OSError as e:
                    # a dial torn before its hello (a peer's aborted earlier
                    # attempt): drop it and keep accepting, the peer re-dials
                    _log.warning("mesh build: dropped a connection from %s torn before its hello: %s", addr, e)
                    _close_quietly(conn)
                    continue
                if src not in others or addr[0] != _HOST_ADDRS[src][0]:
                    _close_quietly(conn)
                    continue
                if src in recv_socks:
                    # a peer re-dialed (its previous attempt aborted): the old socket is dead
                    _close_quietly(recv_socks[src])
                recv_socks[src] = conn
                recv_protos[src] = proto
        # lint: waive(except-swallow) thread hand-off: chained into the incomplete-mesh error
        except BaseException as e:
            accept_err.append(e)

    acceptor = threading.Thread(target=accept_all, daemon=True)
    acceptor.start()
    send_socks: dict[int, socket.socket] = {}
    try:
        for peer in sorted(others, key=lambda p: (p - pid) % max(len(peers), 1)):
            peer_ip, peer_port = _HOST_ADDRS[peer]
            # dial with patience while our own listener stays up: in a
            # concurrent rebuild a refusal only means the peer has not
            # re-listened yet (giving up at once would livelock two peers)
            deadline = time.monotonic() + (timeout_s if timeout_s is not None else 30.0)
            while True:
                try:
                    s = socket.create_connection((peer_ip, peer_port), timeout=timeout_s)
                    break
                except OSError as e:
                    if time.monotonic() >= deadline:
                        raise PeerUnreachable(peer, f"exchange mesh build: cannot connect to process {peer} "
                                                    f"at {peer_ip}:{peer_port}: {e}") from e
                    time.sleep(0.05)
            _configure_link_socket(s)
            s.sendall(struct.pack("!i", _hello_int(pid)))
            send_socks[peer] = s
        acceptor.join(timeout=timeout_s)
        if acceptor.is_alive() or len(recv_socks) != len(others):
            missing = sorted(set(others) - set(recv_socks))
            msg = (f"host exchange mesh incomplete: accepted {len(recv_socks)} of {len(others)} peers"
                   + (f" (missing {missing})" if missing else "")
                   + (f"; the acceptor stopped on {accept_err[0]!r}" if accept_err else ""))
            # name the lowest missing peer: the retry and roll-call tier
            # needs one suspect to treat the failure as transient
            raise (PeerUnreachable(missing[0], msg, missing) if missing else RuntimeError(msg)) from (
                accept_err[0] if accept_err else None)
    except BaseException as e:
        # closing the listener unblocks a live acceptor, so the join cannot hang
        srv.close()
        for s in send_socks.values():
            _close_quietly(s)
        for s in recv_socks.values():
            _close_quietly(s)
        acceptor.join(timeout=timeout_s)
        # the peers whose hello arrived: alive, whatever failed the build
        # (the roll call removes only peers it has not heard)
        e.heard = frozenset(recv_socks)
        raise
    srv.close()
    my_proto = _FRAME_PROTO_CRC if _p2p_crc_enabled() else 0
    # a link carries the CRC trailer only when both ends advertised it
    proto = {p: min(my_proto, recv_protos.get(p, 0)) for p in others}
    return {"send": send_socks, "recv": recv_socks, "proto": proto}


def _links_in_program_order(tag: str) -> None:
    """Build the mesh on the calling thread before an exchange goes to the
    worker (the first build's address gather is a collective, in program
    order). A rebuild that cannot reach a peer (the worker's previous
    exchange tore the mesh down over a dead one) hardens into ``PeerLost``
    as the exchange itself would: in a degraded group always, in a whole
    one when the reliable mode is armed."""
    try:
        _host_links()
    except OSError as e:
        _reset_host_links()
        if _DEGRADED is not None or _p2p_retries() > 0:
            raise PeerLost(getattr(e, "peer", -1), f"exchange {tag!r}: mesh rebuild failed: {e}") from e
        raise


def _host_links() -> dict:
    """The (lazily built) mesh of the current group: every process, or the
    survivors once degraded. The first build is a collective (the address
    gather) unless the addresses are cached; rebuilds are not."""
    global _HOST_LINKS
    with _LINKS_BUILD_LOCK:
        if _HOST_LINKS is not None:
            return _HOST_LINKS
        peers = list(_DEGRADED["survivors"]) if _DEGRADED is not None else list(range(_world_size()))
        _HOST_LINKS = _build_host_links(peers, _p2p_timeout_s())
        return _HOST_LINKS


# -- the ring collectives -----------------------------------------------------------


def _ring_allgather(links: dict, ordered_pids: list[int], rank: int, obj, tag: str,
                    heartbeat: float | None, stats: dict | None = None) -> list:
    """One framed allgather of a host object over an explicit ring:
    ``ordered_pids[rank]`` is this process, links keyed by original pid.
    The one implementation behind the degraded group's collectives, the
    roll call's agreement and the owner-segment collectives. Bumps the
    per-link frame counters like every framed user. ``stats`` receives
    ``payload_bytes``, ``bytes_sent`` (payload × (P − 1)) and
    ``bytes_recv``. Returns the per-rank list."""
    protos = links.get("proto", {})
    parts, total = _encode_host_payload(obj)
    P_ = len(ordered_pids)
    own_pid = ordered_pids[rank]
    plan = faults.active_plan()
    out: dict[int, object] = {rank: obj}
    err: list[BaseException] = []

    def send_all():
        peer_pid = None
        try:
            for r in range(1, P_):
                peer_pid = ordered_pids[(rank + r) % P_]
                seq = _next_link_seq("send", peer_pid)
                wire_parts, corrupt_wire = parts, False
                if plan is not None:
                    spec = plan.pop_send_fault(own_pid, peer_pid, seq, tag)
                    if spec is not None:
                        wire_parts, corrupt_wire = faults.apply_send_fault(spec, parts, links["send"][peer_pid])
                if wire_parts is None:
                    continue  # the frame set was dropped
                _send_frame_parts(links["send"][peer_pid], wire_parts, total,
                                  protos.get(peer_pid, 0) >= _FRAME_PROTO_CRC, peer_pid, tag, heartbeat,
                                  corrupt_wire=corrupt_wire)
        # lint: waive(except-swallow) thread hand-off: re-raised after the join
        except BaseException as e:
            e.peer = getattr(e, "peer", peer_pid)
            err.append(e)

    t = threading.Thread(target=send_all)
    t.start()
    bytes_recv = 0
    # a receive error propagates without the join: the caller's teardown
    # closes the sockets, which ends a sender blocked on a dead peer
    for r in range(1, P_):
        src_rank = (rank - r) % P_
        src_pid = ordered_pids[src_rank]
        sock = links["recv"][src_pid]
        _next_link_seq("recv", src_pid)
        try:
            n = struct.unpack("!q", _recv_exact(sock, 8, src_pid, tag, heartbeat))[0]
            raw = _recv_frame_payload(sock, n, protos.get(src_pid, 0) >= _FRAME_PROTO_CRC, src_pid, tag,
                                      heartbeat)
        except BaseException as e:
            # name the silent link: the roll call wants a suspect
            e.peer = getattr(e, "peer", src_pid)
            raise
        bytes_recv += n
        out[src_rank] = _decode_host_payload(raw)
    t.join()
    if err:
        raise err[0]
    if stats is not None:
        stats.update(payload_bytes=total, bytes_sent=total * (P_ - 1), bytes_recv=bytes_recv)
    return [out[r] for r in range(P_)]


def _p2p_allgather_obj(obj, tag: str = "host_collective", drain: bool = True, stats: dict | None = None) -> list:
    """Allgather one host object over the mesh of the current group (the
    degraded group's collectives, and the owner-segment collectives of a
    whole one). The per-rank list in ascending rank. A synchronous call
    drains the exchange worker first (``drain=False`` is the worker's own
    call). A link failure here hardens into ``PeerLost`` (peer -1 when the
    link is unknown) in a degraded group always, and in a whole one when
    the reliable mode is armed: these collectives have no completion ACK,
    so a retry inside could desync the peers, while the failure is
    symmetric and the caller's roll call decides. With retries unset a
    whole group's error propagates raw."""
    P_ = effective_process_count()
    pid = effective_process_index()
    if P_ <= 1:
        if stats is not None:
            stats.update(payload_bytes=0, bytes_sent=0, bytes_recv=0)
        return [obj]
    if drain:
        drain_async_exchanges()
    try:
        links = _host_links()
        heartbeat = _p2p_heartbeat_s() if _sink_active() else None
        return _ring_allgather(links, [_orig_pid(r) for r in range(P_)], pid, obj, tag, heartbeat, stats=stats)
    except BaseException as e:
        _reset_host_links()
        if isinstance(e, OSError):
            if _DEGRADED is not None:
                raise PeerLost(getattr(e, "peer", -1), f"degraded-group host collective {tag!r} failed: {e}") from e
            if _p2p_retries() > 0:
                raise PeerLost(getattr(e, "peer", -1),
                               f"host collective {tag!r} failed on the full mesh: {e}") from e
        raise


def allgather_obj_p2p(obj, tag: str = "host_collective", stats: dict | None = None) -> list:
    """Every process's host object in rank order, over the mesh of the
    current group (whole or degraded): the owner-segment collectives ride
    it. Array payloads travel raw. ``[obj]`` on one process. A collective."""
    return _p2p_allgather_obj(obj, tag=tag, stats=stats)


def _fragment_may_proceed(survivors, group) -> bool:
    """The roll call's split-brain quorum: a fragment proceeds iff it holds
    a strict majority of the group's members, or exactly half of them
    including the group's writer (its lowest member). Only members count:
    an invited rejoiner in the agreed set is no member yet, and letting it
    pad a fragment would let two fragments pass. At most one fragment of
    any partition passes."""
    group = sorted(group)
    writer = group[0]
    members = [s for s in survivors if s in group]
    if 2 * len(members) > len(group):
        return True
    return 2 * len(members) == len(group) and writer in members


def roll_call(window_s: float | None = None, candidates: Sequence[int] | None = None,
              guard_group: Sequence[int] | None = None) -> list[int]:
    """The survivor census after a suspected loss. Every process that met
    ``PeerLost`` on the same exchange calls it at the same program point:
    each rebuilds a mesh over the candidates from the cached addresses,
    dropping a peer that stays unreachable past the window
    (``PHOTON_ROLLCALL_WINDOW_S``, default 10 s), then the survivors trade
    their reachable sets over the mesh and agree on the intersection. Of
    the peers a failed build missed, the lowest one whose hello this
    process has not heard for the window is dropped: a live peer dials on
    every build attempt of its own, from its exchange retries or its roll
    call, so a build that failed on a dead peer or on a rejoiner not yet
    invited (which answers no build) does not drop a live peer that was
    missed mid-rebuild.
    Returns the sorted surviving original indices (this process among
    them). ``candidates`` widens the census past the current group and
    ``guard_group`` names the membership the quorum is judged by (both for
    the rejoin roll call: survivors and invited rejoiners, judged by the
    current group, which a rejoiner joins only once agreed); a fragment
    without the quorum (``_fragment_may_proceed``) raises rather than risk
    a second writer."""
    global _HOST_LINKS
    if window_s is None:
        env = os.environ.get("PHOTON_ROLLCALL_WINDOW_S")
        window_s = float(env) if env else 10.0
    with _LINKS_BUILD_LOCK:
        _reset_host_links()
        pid = _self_pid()
        if guard_group is not None:
            group = sorted(int(p) for p in guard_group)
        elif _DEGRADED is not None:
            group = list(_DEGRADED["survivors"])
        else:
            group = list(range(_world_size()))
        candidates = list(group) if candidates is None else sorted(int(p) for p in candidates)
        deadline = time.monotonic() + window_s
        # survivors enter at times spread over their retry budgets, and each
        # removal needs one more agreement over the reduced set: keep probing
        # past the window up to a give-up that grows with every removal
        give_up = deadline + window_s
        probe_timeout = max(min(2.0, window_s / 4.0), 0.2)
        survivors = None
        # when each candidate's hello last reached this process's listener
        heard: dict[int, float] = {}
        while len(candidates) > 1:
            try:
                links = _build_host_links(candidates, probe_timeout)
            # lint: waive(except-swallow) the census: a silent peer is dropped; roll_call records it
            except PeerUnreachable as e:
                now = time.monotonic()
                heard.update((p, now) for p in getattr(e, "heard", ()))
                # the missed peers not heard for the window: a live peer
                # missed mid-rebuild is never the one dropped
                silent = [m for m in e.missing if m in candidates and heard.get(m, -np.inf) < now - window_s]
                if now >= deadline and silent:
                    candidates.remove(silent[0])
                    # the reduced set gets a fresh window: its members may
                    # still be probing the removed peer
                    deadline = now + window_s
                    give_up = max(give_up, deadline + window_s)
                elif now >= give_up:
                    break
                else:
                    time.sleep(probe_timeout / 2.0)
                continue
            # lint: waive(except-swallow) a build race: retried until the give-up
            except (OSError, RuntimeError) as e:
                # a build race (two peers mid-rebuild): retry until the give-up
                heard.update((p, time.monotonic()) for p in getattr(e, "heard", ()))
                if time.monotonic() >= give_up:
                    break
                time.sleep(probe_timeout / 2.0)
                continue
            _HOST_LINKS = links
            try:
                views = _ring_allgather(links, candidates, candidates.index(pid), list(candidates), "rollcall",
                                        None)
            # lint: waive(except-swallow) the agreement raced a failing build: retried until the give-up
            except OSError:
                # the agreement raced a peer whose own build failed after ours
                # succeeded: rebuild and agree again
                _reset_host_links()
                if time.monotonic() >= give_up:
                    break
                time.sleep(probe_timeout / 2.0)
                continue
            agreed = set(candidates)
            for v in views:
                agreed &= set(v)
            if pid not in agreed:
                _reset_host_links()
                raise RuntimeError(f"roll call excluded this process ({pid}): survivors agreed on {sorted(agreed)}")
            if agreed != set(candidates):
                # another survivor could not reach a candidate this one could:
                # the intersection, rebuilt
                _reset_host_links()
                candidates = sorted(agreed)
                if len(candidates) > 1:
                    _HOST_LINKS = _build_host_links(candidates, _p2p_timeout_s())
            survivors = sorted(candidates)
            break
        if survivors is None:
            _reset_host_links()
            survivors = [pid]
        if not _fragment_may_proceed(survivors, group):
            _reset_host_links()
            emit_event("roll_call_abort", survivors=survivors, group=list(group))
            raise RuntimeError(
                f"roll call reached only {survivors} of {sorted(group)}: a fragment without a strict member "
                f"majority (or exactly half the group including the writer, process {min(group)}) must abort "
                "rather than risk a split-brain second writer — restart this process")
        emit_event("roll_call", survivors=survivors, lost=[p for p in group if p not in survivors])
        return survivors


def _host_p2p_exchange(arrays, order, starts, counts_matrix=None, transport: str = "p2p_host", tag: str = "",
                       stats: dict | None = None):
    """The mesh transport of ``exchange_rows``: each (source, destination)
    block travels exactly, length-prefixed, over its pair's own link, with
    no padding under any skew. Sends run on a helper thread in rotation
    order (round r: send to rank + r, receive from rank − r), so every
    receiver drains concurrently. The result's layout is the gloo
    transport's (ascending source, stable within a source).

    Any error tears this process's mesh down. With ``PHOTON_P2P_RETRIES``
    > 0 a transient link fault (refused connect, timeout, EOF, CRC
    mismatch: an ``OSError``) is retried with backoff through the rebuild
    from the cached addresses, with no collective, so a retry is legal on
    the exchange worker; the completion ACK makes every process see the
    same outcome, so all retry the same exchange. Retries exhausted against
    an unreachable peer harden into ``PeerLost``. ``stats`` (else
    ``LAST_EXCHANGE_STATS``) receives the exchange's stats."""
    retries = _p2p_retries()
    attempt = 0
    while True:
        try:
            return _host_p2p_exchange_impl(arrays, order, starts, counts_matrix, transport, tag, stats)
        except BaseException as e:
            # closing the sockets also unblocks a sender stuck on a stalled peer
            _reset_host_links()
            transient = isinstance(e, OSError)
            if transient and attempt < retries:
                attempt += 1
                backoff = _retry_backoff_sleep(attempt - 1)
                REGISTRY.counter_inc("p2p.retries")
                emit_event("p2p_retry", attempt=attempt, max_attempts=retries, tag=tag, error=type(e).__name__,
                           peer=getattr(e, "peer", None), backoff_s=backoff)
                if backoff > 0.0:
                    time.sleep(backoff)
                continue
            if retries and transient:
                REGISTRY.counter_inc("p2p.giveups")
                emit_event("p2p_giveup", attempts=attempt, tag=tag, error=type(e).__name__,
                           peer=getattr(e, "peer", None))
                if isinstance(e, PeerUnreachable):
                    raise PeerLost(e.peer, f"exchange retries exhausted ({retries}) against unreachable "
                                           f"process {e.peer}: {e}") from e
            raise


def _host_p2p_exchange_impl(arrays, order, starts, counts_matrix, transport: str = "p2p_host", tag: str = "",
                            stats: dict | None = None):
    """One attempt. ``counts_matrix=None`` is the collective-free framing
    (the overlapped schedule): each block's row count comes from its
    length prefix, validated per key (a whole number of rows, every key of
    a source agreeing)."""
    P_ = effective_process_count()
    pid = effective_process_index()
    links = _host_links()
    protos = links.get("proto", {})
    reliable = _p2p_retries() > 0
    plan = faults.active_plan()
    keys = sorted(arrays)
    parts: dict[str, dict[int, np.ndarray]] = {
        k: {pid: np.ascontiguousarray(arrays[k][order[starts[pid]:starts[pid + 1]]])} for k in keys}
    bytes_sent = 0
    send_err: list[BaseException] = []
    # decided once an exchange: the framing never flips mid-exchange
    telemetry = _sink_active()
    heartbeat = _p2p_heartbeat_s() if telemetry else None

    def send_all():
        nonlocal bytes_sent
        try:
            for r in range(1, P_):
                peer = (pid + r) % P_
                o_pid, o_peer = _orig_pid(pid), _orig_pid(peer)
                sock = links["send"][o_peer]
                crc = protos.get(o_peer, 0) >= _FRAME_PROTO_CRC
                seq = _next_link_seq("send", o_peer)
                t_start, t0 = time.time(), time.perf_counter()
                rows = order[starts[peer]:starts[peer + 1]]
                bufs = [np.ascontiguousarray(arrays[k][rows]).tobytes() for k in keys]
                corrupt_wire = False
                if plan is not None:
                    spec = plan.pop_send_fault(o_pid, o_peer, seq, tag)
                    if spec is not None:
                        bufs, corrupt_wire = faults.apply_send_fault(spec, bufs, sock)
                peer_bytes = 0
                if bufs is not None:  # None: the frame set was dropped
                    for j, buf in enumerate(bufs):
                        _send_frame(sock, buf, crc, o_peer, tag, heartbeat, corrupt_wire=corrupt_wire and j == 0)
                        peer_bytes += len(buf)
                bytes_sent += peer_bytes
                if telemetry:
                    emit_event("p2p_send", peer=o_peer, bytes=peer_bytes, rows=int(starts[peer + 1] - starts[peer]),
                               dur_s=time.perf_counter() - t0, t_start=t_start, corr=f"p2p:{o_pid}>{o_peer}#{seq}",
                               tag=tag, transport=transport)
        # lint: waive(except-swallow) thread hand-off: re-raised after the join
        except BaseException as e:  # surfaced after the join
            send_err.append(e)

    sender = threading.Thread(target=send_all)
    sender.start()
    # a receive error propagates without the join (as in ``_ring_allgather``)
    for r in range(1, P_):
        src = (pid - r) % P_
        o_pid, o_src = _orig_pid(pid), _orig_pid(src)
        sock = links["recv"][o_src]
        crc = protos.get(o_src, 0) >= _FRAME_PROTO_CRC
        seq = _next_link_seq("recv", o_src)
        t_start, t0 = time.time(), time.perf_counter()
        src_bytes = src_rows = 0
        n_src: int | None = None
        for k in keys:
            a = arrays[k]
            row_bytes = a.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
            got = struct.unpack("!q", _recv_exact(sock, 8, o_src, tag, heartbeat))[0]
            if counts_matrix is not None:
                n = int(counts_matrix[src, pid])
                want = n * row_bytes
                if got != want:
                    raise RuntimeError(f"exchange size mismatch from process {o_src} key {k!r}: expected "
                                       f"{want} bytes ({n} rows), got {got}")
            else:
                if row_bytes <= 0 or got % row_bytes:
                    raise RuntimeError(f"exchange frame from process {o_src} key {k!r}: {got} bytes is not "
                                       f"a multiple of the {row_bytes}-byte row")
                n = got // row_bytes
                if n_src is None:
                    n_src = n
                elif n != n_src:
                    raise RuntimeError(f"exchange frames from process {o_src} disagree on row count: key "
                                       f"{k!r} carries {n} rows, earlier keys carried {n_src}")
            raw = _recv_frame_payload(sock, got, crc, o_src, tag, heartbeat)
            src_bytes += got
            src_rows = n
            parts[k][src] = np.frombuffer(raw, a.dtype).reshape((n,) + a.shape[1:]).copy()
        if telemetry:
            emit_event("p2p_recv", peer=o_src, bytes=src_bytes, rows=int(src_rows),
                       dur_s=time.perf_counter() - t0, t_start=t_start, corr=f"p2p:{o_src}>{o_pid}#{seq}",
                       tag=tag, transport=transport)
    sender.join()
    if send_err:
        raise send_err[0]
    if reliable:
        # the completion ACK (reliable mode only, absent from the knob-off
        # wire): a link's ACK comes only after its peer finished its whole
        # exchange, so any failure fails every process's exchange
        for r in range(1, P_):
            peer = (pid + r) % P_
            _sendall_hb(links["send"][_orig_pid(peer)], _ACK_BYTE, _orig_pid(peer), tag, heartbeat)
        for r in range(1, P_):
            o_src = _orig_pid((pid - r) % P_)
            got = _recv_exact(links["recv"][o_src], 1, o_src, tag, heartbeat)
            if got != _ACK_BYTE:
                raise RuntimeError(f"exchange completion ACK from process {o_src} carries {got!r} (stream desync)")
    counts_send = np.diff(starts)
    out_stats = dict(bytes_sent=bytes_sent, rows_sent=int(counts_send.sum()),
                     padded_rows=int(counts_send.sum()) * len(arrays), transport=transport)
    (LAST_EXCHANGE_STATS if stats is None else stats).update(out_stats)
    return {k: np.concatenate([parts[k][s] for s in range(P_)]) for k in keys}


# ---------------------------------------------------------------------------
# the overlapped schedule (PHOTON_RE_SHARD=1)
# ---------------------------------------------------------------------------
# An exchange is issued at one program point and joined at a later one,
# with solves, host work and gloo collectives of the main thread in
# between. Its body runs on one worker thread a process, in submission
# order, on the mesh alone (collective-free: row counts ride the length
# prefixes), so it never pairs against the main thread's collectives. The
# mesh's first build (a collective) happens on the calling thread, in
# program order.
_EXCHANGE_POOL: list = [None]
_EXCHANGE_LOCK = threading.Lock()  # the pending list and the overlap books
_PENDING_EXCHANGES: list = []
_EXCHANGE_TOTALS = {"exchange_s": 0.0, "wait_s": 0.0}


def _exchange_pool() -> ThreadPoolExecutor:
    # created under the lock: two first uses at once must not start two
    # workers, which would run exchanges out of program order
    with _EXCHANGE_LOCK:
        if _EXCHANGE_POOL[0] is None:
            _EXCHANGE_POOL[0] = ThreadPoolExecutor(max_workers=1, thread_name_prefix="photon-exchange")
        return _EXCHANGE_POOL[0]


def _record_overlap(kind: str, seconds: float) -> None:
    """The exchange's (``exchange_s``, on the worker) or the consumer's
    blocked (``wait_s``) seconds, as the timers ``re_exchange.*``, and the
    gauge ``re_shard.exchange_overlap_ratio``: the share of exchange wall
    the consumer did not block on (1.0 hidden, 0.0 a barrier; 1.0 on one
    process, where there is nothing to wait for)."""
    with _EXCHANGE_LOCK:
        _EXCHANGE_TOTALS[kind] += seconds
        wall, wait = _EXCHANGE_TOTALS["exchange_s"], _EXCHANGE_TOTALS["wait_s"]
    REGISTRY.timer_add(f"re_exchange.{kind}", seconds)
    ratio = 1.0 if wall <= 0.0 else max(0.0, min(1.0, 1.0 - wait / wall))
    REGISTRY.gauge_set("re_shard.exchange_overlap_ratio", ratio)


def _forget_pending(future) -> None:
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES[:] = [e for e in _PENDING_EXCHANGES if e[0] is not future]


class ExchangeHandle:
    """A pending ``exchange_rows_async``. ``result()`` blocks until the
    rows land and returns ``exchange_rows``' dict, or what the epilogue
    ``finish(rows, stats)`` makes of it. The first call joins, under a
    lock, so any thread may join (a prefetch worker, the main thread) and
    the epilogue runs once; later calls return the same value (a failed
    exchange raises its error to every caller). The blocked seconds go to
    ``re_exchange.wait_s`` (and an ``exchange_wait`` record while a sink is
    on). ``stats`` holds the exchange's ``LAST_EXCHANGE_STATS`` keys, its
    ``seconds`` on the worker and the joiner's ``wait_s`` once joined."""

    def __init__(self, future=None, value=None, tag: str = "", stats: dict | None = None, finish=None):
        self._future = future
        self._value = value
        self._tag = tag
        self._finish = finish
        self._joined = False
        self._lock = threading.Lock()
        self.stats = stats

    @property
    def done(self) -> bool:
        return self._future is None or self._future.done()

    def result(self):
        with self._lock:
            if not self._joined:
                out = self._value
                if self._future is not None:
                    t0 = time.perf_counter()
                    try:
                        out, stats = self._future.result()
                    finally:
                        waited = time.perf_counter() - t0
                        _record_overlap("wait_s", waited)
                        emit_event("exchange_wait", tag=self._tag, wait_s=waited)
                        _forget_pending(self._future)
                    self.stats = dict(stats, wait_s=waited)
                self._value = out if self._finish is None else self._finish(out, self.stats)
                self._future = self._finish = None
                self._joined = True
            return self._value


def exchange_rows_async(arrays, dest: np.ndarray, tag: str = "", finish=None) -> ExchangeHandle:
    """``exchange_rows`` without blocking: a handle whose ``result()`` is
    the same dict (or ``finish(rows, stats)`` of it). The rows travel on
    the exchange worker over the mesh, always (collective-free, and
    padding-free for the skewed workloads the schedule exists for;
    ``transport`` ``p2p_host_async``). Every process calls it at the same
    program point; the arrays must not change until the handle is joined.
    On one process it completes inline (the identity), recording zero
    seconds so the overlap gauge exists there too."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    dest = np.asarray(dest, np.int64).reshape(-1)
    P_ = process_count()
    if P_ <= 1:
        _record_overlap("exchange_s", 0.0)
        _record_overlap("wait_s", 0.0)
        return ExchangeHandle(value=arrays, finish=finish, stats=dict(
            bytes_sent=0, rows_sent=len(dest), padded_rows=len(dest), transport="local", seconds=0.0, wait_s=0.0))
    order = np.argsort(dest, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(dest, minlength=P_).astype(np.int64))])
    _links_in_program_order(tag)

    def run():
        t0 = time.perf_counter()
        stats: dict = {}
        try:
            out = _host_p2p_exchange(arrays, order, starts, None, transport="p2p_host_async", tag=tag, stats=stats)
        finally:
            dur = time.perf_counter() - t0
            _record_overlap("exchange_s", dur)
            emit_event("exchange", tag=tag, dur_s=dur)
        return out, dict(stats, seconds=dur)

    fut = _exchange_pool().submit(run)
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.append((fut, tag))
    return ExchangeHandle(future=fut, tag=tag, finish=finish)


class ObjCollectiveHandle:
    """A pending ``allgather_obj_p2p_async``: ``result()`` blocks until the
    allgather lands and returns the per-rank list. It books nothing into
    the ``re_exchange.*`` overlap accounting (owner-segment callers keep
    their own ``re_combine.*`` books)."""

    def __init__(self, future=None, value=None, tag: str = ""):
        self._future = future
        self._value = value
        self._tag = tag

    def result(self) -> list:
        if self._future is None:
            return self._value
        try:
            out = self._future.result()
        finally:
            _forget_pending(self._future)
        self._future = None
        self._value = out
        return out


def allgather_obj_p2p_async(obj, tag: str = "host_collective", stats: dict | None = None) -> ObjCollectiveHandle:
    """``allgather_obj_p2p`` on the exchange worker: the frames go on the
    wire while the caller keeps working (the owner-segment combine packs
    its diagnostics under the coefficient segments' send). The mesh's first
    build happens here on the calling thread; the body runs on the worker
    in submission order. ``stats`` is filled by the worker (the byte counts
    and ``exchange_s``, its seconds there) before the handle resolves.
    ``[obj]`` inline on one process."""
    if process_count() <= 1:
        if stats is not None:
            stats.update(payload_bytes=0, bytes_sent=0, bytes_recv=0, exchange_s=0.0)
        return ObjCollectiveHandle(value=[obj], tag=tag)
    _links_in_program_order(tag)

    def run():
        t0 = time.perf_counter()
        try:
            return _p2p_allgather_obj(obj, tag=tag, drain=False, stats=stats)
        finally:
            if stats is not None:
                stats["exchange_s"] = time.perf_counter() - t0

    fut = _exchange_pool().submit(run)
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.append((fut, tag))
    return ObjCollectiveHandle(future=fut, tag=tag)


def drain_async_exchanges() -> None:
    """Wait for every exchange in flight (each result stays claimable
    through its handle, which re-raises a failure). A synchronous mesh user
    drains first, so the sockets see one global order; the streamed
    trainer drains before a checkpoint, a re-plan and the fit's end. A
    worker failure seen here is recorded (``exchange_drain_error``,
    ``p2p.exchange_drain_errors``) and its entry dropped, so later drains
    neither wait on nor report it again."""
    with _EXCHANGE_LOCK:
        pending = list(_PENDING_EXCHANGES)
    for entry in pending:
        fut, tag = entry
        exc = fut.exception()  # waits; the handle re-raises on result()
        if exc is not None:
            with _EXCHANGE_LOCK:
                if entry in _PENDING_EXCHANGES:
                    _PENDING_EXCHANGES.remove(entry)
            REGISTRY.counter_inc("p2p.exchange_drain_errors")
            emit_event("exchange_drain_error", tag=tag, error=type(exc).__name__, peer=getattr(exc, "peer", None))


def reset_async_exchanges() -> None:
    """Forget every pending exchange without waiting: recovery abandons the
    failed attempt's handles wholesale."""
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.clear()


def _stop_exchange_worker() -> None:
    """Drain, stop the worker and forget the books (at shutdown)."""
    drain_async_exchanges()
    with _EXCHANGE_LOCK:
        pool, _EXCHANGE_POOL[0] = _EXCHANGE_POOL[0], None
    if pool is not None:
        # outside the lock: a finishing exchange books its overlap under it
        pool.shutdown(wait=True)
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.clear()
        _EXCHANGE_TOTALS.update(exchange_s=0.0, wait_s=0.0)


def confirm_peer_loss(err) -> tuple[list[int], list[int], list[int]]:
    """The confirmation every ``PeerLost`` recovery shares (the streamed
    fit's checkpoint re-entry, the in-memory descent's degrade in place):
    count and record the suspected loss, drop the failed attempt's pending
    exchanges, roll-call the current group and return ``(group, survivors,
    lost)``. An empty ``lost`` means every peer answered (a link flap): the
    caller retries rather than degrades."""
    REGISTRY.counter_inc("fleet.peer_lost")
    emit_event("peer_lost", peer=int(getattr(err, "peer", -1)), error=str(err))
    reset_async_exchanges()
    group = list(_DEGRADED["survivors"]) if _DEGRADED is not None else list(range(original_process_count()))
    survivors = roll_call()
    return group, survivors, sorted(set(group) - set(survivors))


# -- elastic rejoin (PHOTON_REJOIN) ---------------------------------------------------
# The degraded group shrinks the world in place; rejoin grows it back. A lost
# process re-execs (a plan's ``rejoin`` op, or an operator's restart), takes
# its original identity and every mesh address from the mesh cache and waits
# to be invited; the survivors probe, invite and run one roll call over
# survivors and rejoiners, and the agreed group goes on over the mesh.


def rejoin_enabled() -> bool:
    """``PHOTON_REJOIN`` (strict int parse; unset or 0: lost peers stay
    lost)."""
    env = os.environ.get("PHOTON_REJOIN")
    if env is not None and env != "":
        return int(env) != 0
    return False


def rejoin_window_s() -> float:
    """``PHOTON_REJOIN_WINDOW_S`` (seconds, strict float parse, default
    10): how long the group waits for returning peers at the first visit
    boundary after a degrade (later boundaries probe once), and, times
    four, how long a booting rejoiner waits for its invite."""
    env = os.environ.get("PHOTON_REJOIN_WINDOW_S")
    if env is not None and env != "":
        return max(float(env), 0.0)
    return 10.0


def _mesh_cache_path() -> str | None:
    """``PHOTON_MESH_CACHE``: the file the first address gather writes
    every process's mesh address to, and a rejoin boot reads. Unset:
    nothing is written."""
    return os.environ.get("PHOTON_MESH_CACHE") or None


def _maybe_persist_mesh_addrs() -> None:
    """Write the gathered address table for later rejoiners, by atomic
    replace (every process writes: on a shared file system the copies are
    the same bytes). A failed write is recorded, never fatal: the cache
    enables rejoin and nothing else reads it."""
    from photon_ml_tpu_torch.utils.atomic_io import atomic_replace_bytes

    path = _mesh_cache_path()
    if path is None or _HOST_ADDRS is None:
        return
    doc = {"world": _world_size(), "addrs": {str(p): [ip, int(port)] for p, (ip, port) in sorted(_HOST_ADDRS.items())}}
    try:
        atomic_replace_bytes(os.path.dirname(path) or ".", path, json.dumps(doc).encode())
    except OSError as e:
        emit_event("mesh_cache_write_failed", path=path, error=str(e))


def bootstrap_rejoin(pid: int | None = None, path: str | None = None) -> dict:
    """Take a lost process's original identity in a fresh interpreter: read
    the mesh cache, record ``(pid, world)`` as this process's identity and
    every address for the mesh, ready for ``rejoin_wait``. ``pid`` defaults
    to ``PHOTON_REJOIN_BOOT`` (set by the ``rejoin`` op in the re-exec'd
    child), ``path`` to ``PHOTON_MESH_CACHE``. Joins no gloo group."""
    global _HOST_ADDRS, _REJOIN_IDENTITY
    if pid is None:
        env = os.environ.get("PHOTON_REJOIN_BOOT")
        if not env:
            raise RuntimeError("bootstrap_rejoin needs the original process index: pass pid= or set PHOTON_REJOIN_BOOT")
        pid = int(env)
    path = path or _mesh_cache_path()
    if path is None:
        raise RuntimeError("bootstrap_rejoin needs the persisted mesh cache: set PHOTON_MESH_CACHE (the same path "
                           "the original group ran with) or pass path=")
    with open(path) as f:
        doc = json.load(f)
    addrs = {int(p): (str(ip), int(port)) for p, (ip, port) in doc["addrs"].items()}
    if pid not in addrs:
        raise RuntimeError(f"mesh cache {path!r} has no address for process {pid} (recorded: {sorted(addrs)})")
    _reset_host_links()
    _HOST_ADDRS = addrs
    _REJOIN_IDENTITY = {"pid": int(pid), "world": int(doc["world"])}
    emit_event("rejoin_boot", pid=int(pid), world=int(doc["world"]))
    return dict(_REJOIN_IDENTITY)


# hello versions reserved for the rejoin rendezvous: the frame protocol uses
# 0 and 1, so a rejoiner tells a probe or an invite from a mesh build's dial
# and stays out of a build it was not named in
_HELLO_PROBE = 0x7D
_HELLO_INVITE = 0x7E


def probe_rejoiners(lost: Sequence[int], window_s: float = 0.0, poll_s: float = 0.25) -> list[int]:
    """Which of the ``lost`` original indices are back and listening at
    their recorded address (one connect and a hello answered by the ACK
    byte; refused or silent: not back). Per-process I/O, not a collective:
    the caller broadcasts the answer before acting on it. ``window_s``
    polls every ``poll_s`` until one answers or the window closes."""
    if _HOST_ADDRS is None:
        return []
    deadline = time.monotonic() + max(window_s, 0.0)
    present: list[int] = []
    while True:
        for p in lost:
            if p in present or p not in _HOST_ADDRS:
                continue
            try:
                with socket.create_connection(_HOST_ADDRS[p], timeout=0.5) as s:
                    s.settimeout(2.0)
                    s.sendall(struct.pack("!i", _self_pid() | (_HELLO_PROBE << 16)))
                    if _recv_exact(s, 1) == _ACK_BYTE:
                        present.append(p)
            # lint: waive(except-swallow) a probe: no answer means not present
            except OSError:
                continue
        if present or time.monotonic() >= deadline:
            return sorted(present)
        time.sleep(poll_s)


def send_rejoin_invites(present: Sequence[int], candidates: Sequence[int], survivors: Sequence[int]) -> list[int]:
    """Send each probed rejoiner the invitation: the roll call's candidates
    and the current survivors, all it needs to enter the roll call the
    survivors run next. Returns those that answered with the ACK byte; one
    that died since the probe drops out of the roll call like any
    unreachable candidate."""
    payload = pickle.dumps({"candidates": [int(c) for c in sorted(candidates)],
                            "survivors": [int(s) for s in sorted(survivors)]}, protocol=4)
    invited: list[int] = []
    for p in present:
        try:
            with socket.create_connection(_HOST_ADDRS[p], timeout=2.0) as s:
                s.settimeout(5.0)
                s.sendall(struct.pack("!i", _self_pid() | (_HELLO_INVITE << 16)))
                s.sendall(struct.pack("!q", len(payload)))
                s.sendall(payload)
                if _recv_exact(s, 1) == _ACK_BYTE:
                    invited.append(int(p))
        # lint: waive(except-swallow) an invite not ACKed: the returned list omits it
        except OSError:
            continue
    return invited


def rejoin_wait(window_s: float | None = None) -> dict | None:
    """A rejoiner's side of the rendezvous: listen at this process's
    recorded address, answer probes and wait up to ``window_s`` (default
    ``rejoin_window_s()``) for an invite. Returns the invite (``candidates``
    and ``survivors``), or None when the window closes first.

    A dial that is neither a probe nor an invite (a degrade roll call
    racing this boot dials the same address) is closed unanswered: the
    rejoiner must not wedge a mesh build it was not named in (that build
    misses it and the roll call drops it for the round; a later boundary
    invites it). As in a mesh build, only a recorded process, from its
    recorded address, is heard (an invite is unpickled). The listener
    closes before the return, so the rejoin roll call can bind the address
    again."""
    if _REJOIN_IDENTITY is None or _HOST_ADDRS is None:
        raise RuntimeError("rejoin_wait outside a rejoin boot: call bootstrap_rejoin first")
    if window_s is None:
        window_s = rejoin_window_s()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        srv.bind(_HOST_ADDRS[_self_pid()])
        srv.listen(8)
        deadline = time.monotonic() + max(window_s, 0.0)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            srv.settimeout(min(remaining, 1.0))
            try:
                conn, addr = srv.accept()
            # lint: waive(except-swallow) the accept timeout is the window's poll tick
            except socket.timeout:
                continue
            try:
                if addr[0] not in {ip for ip, _ in _HOST_ADDRS.values()}:
                    continue
                conn.settimeout(5.0)
                src, kind = _decode_hello(struct.unpack("!i", _recv_exact(conn, 4))[0])
                if src not in _HOST_ADDRS or addr[0] != _HOST_ADDRS[src][0]:
                    continue
                if kind == _HELLO_PROBE:
                    conn.sendall(_ACK_BYTE)
                    continue
                if kind != _HELLO_INVITE:
                    continue  # a mesh build's dial: closed unanswered
                n = struct.unpack("!q", _recv_exact(conn, 8))[0]
                payload = pickle.loads(_recv_exact(conn, n))
                conn.sendall(_ACK_BYTE)
                emit_event("rejoin_invited", inviter=int(src), candidates=payload.get("candidates"),
                           survivors=payload.get("survivors"))
                return payload
            # lint: waive(except-swallow) a torn or foreign connection is dropped
            except OSError:
                continue
            finally:
                _close_quietly(conn)
    finally:
        _close_quietly(srv)
