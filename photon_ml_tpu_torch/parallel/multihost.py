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

``exchange_rows_async`` issues an exchange and returns a handle to join
later (the overlapped schedule of ``PHOTON_RE_SHARD``): one worker thread
a process runs the exchanges in submission order over a second gloo group
of their own, so they never pair against the main thread's collectives.

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
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.obs import devcost
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.spans import emit_event

BACKEND = "gloo"
# seconds a collective waits for the other processes before it raises
DEFAULT_TIMEOUT_S = 600.0

# the process group's collective timeout, which the exchange group takes too
_TIMEOUT_S = [DEFAULT_TIMEOUT_S]

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
    _TIMEOUT_S[0] = float(timeout_s)
    try:
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, timeout=timedelta(seconds=timeout_s),
        )
    except (ValueError, RuntimeError) as e:
        raise _init_error(str(e)) from e
    return runtime_summary()


def shutdown_multihost() -> None:
    """Leave the process group (a no-op outside one), after the exchange
    worker has drained."""
    if dist.is_initialized():
        _reset_async_exchanges()
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


def _gather_bytes(payload: bytes, group=None) -> list[bytes]:
    """Every process's ``payload`` in rank order (two all_gathers: the
    sizes, then the bytes padded to the largest). ``group`` None is the
    default group, whose calls ``collective_stats`` counts; the exchange
    worker's group (``exchange_rows_async``) keeps its own books."""
    t0 = time.perf_counter()
    p = process_count()
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(p)]
    dist.all_gather(sizes, size, group=group)
    width = max(int(s) for s in sizes)
    buf = torch.zeros(max(width, 1), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(p)]
    dist.all_gather(outs, buf, group=group)
    if group is None:
        collective_stats["seconds"] += time.perf_counter() - t0
        collective_stats["calls"] += 1
        collective_stats["bytes"] += p * buf.numel()
    return [bytes(o[: int(s)].numpy()) for o, s in zip(outs, sizes)]


def _gather_arrays(arrays: Sequence[np.ndarray], group=None) -> list[list[np.ndarray]]:
    """Every process's ``arrays`` (same count, shapes and dtypes on every
    process) in rank order, moved in one gather of their bytes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    payload = b"".join(a.tobytes() for a in arrays)
    out = []
    for blob in _gather_bytes(payload, group):
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


def _gather_same(arrays: Sequence[np.ndarray], group=None) -> list[list[np.ndarray]]:
    """``_gather_arrays`` for callers whose every process passes the same
    count, shapes and dtypes by construction (lock-step collectives): one
    all_gather of the bytes, without the exchange of sizes first."""
    t0 = time.perf_counter()
    arrays = [np.ascontiguousarray(a) for a in arrays]
    payload = b"".join(a.tobytes() for a in arrays)
    buf = torch.zeros(max(len(payload), 1), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(outs, buf, group=group)
    if group is None:
        collective_stats["seconds"] += time.perf_counter() - t0
        collective_stats["calls"] += 1
        collective_stats["bytes"] += len(outs) * buf.numel()
    out = []
    for o in outs:
        blob, parts, pos = o.numpy(), [], 0
        for a in arrays:
            parts.append(np.frombuffer(blob, dtype=a.dtype, count=a.size, offset=pos).reshape(a.shape).copy())
            pos += a.nbytes
        out.append(parts)
    return out


def _reduce(arrays, op, wire_dtype=np.float64, gather=_gather_arrays):
    if process_count() <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    gathered = gather([np.asarray(a, wire_dtype) for a in arrays])
    out = tuple(op(np.stack([g[i] for g in gathered]).astype(np.float64, copy=False), axis=0)
                for i in range(len(arrays)))
    return out if len(out) > 1 else out[0]


def allreduce_sum_host(*arrays: np.ndarray):
    """Sum numpy arrays across all processes (returned unchanged on one):
    each array is gathered as float64 and summed in rank order, so every
    process receives identical bytes. One array in, one out; several in,
    a tuple out. The streamed objective's per-process partial sums meet
    here: the treeAggregate of the out-of-core path."""
    return _reduce(arrays, np.sum)


def allreduce_sum_lockstep(*arrays: np.ndarray, wire_dtype=np.float64):
    """``allreduce_sum_host`` for arrays of the same shapes on every process
    by construction (the feature-range-sharded objective's margins and
    scalars): one all_gather instead of two, each array on the wire as
    ``wire_dtype`` (float32 partials lose nothing on a float32 wire, at
    half the bytes), summed in float64 in rank order."""
    return _reduce(arrays, np.sum, wire_dtype, _gather_same)


def allgather_concat(array: np.ndarray) -> np.ndarray:
    """Every process's 1-D ``array`` (one dtype everywhere, lengths free)
    concatenated in rank order: data movement only, so the result holds
    each process's bytes as they were. ``array`` itself on one process."""
    array = np.ascontiguousarray(array)
    if process_count() <= 1:
        return array
    return np.concatenate([np.frombuffer(b, dtype=array.dtype) for b in _gather_bytes(array.tobytes())])


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
    if process_count() <= 1:
        LAST_EXCHANGE_STATS.update(bytes_sent=0, rows_sent=len(dest), padded_rows=len(dest),
                                   transport="local")
        return arrays
    t0 = time.perf_counter()
    out, stats, (send, recv) = _exchange_on(arrays, dest, tag, None)
    # the exchange's bytes in the run's telemetry, once per (sent, received)
    # size, recorded after the collective: no process waits on another's capture
    devcost.capture("multihost.all_to_all", (send, recv),
                    lambda: {"flops": 0.0, "bytes_accessed": float(send.numel() + recv.numel()),
                             "memory": {"argument_size_in_bytes": send.numel(),
                                        "output_size_in_bytes": recv.numel()}})
    collective_stats["seconds"] += time.perf_counter() - t0
    collective_stats["calls"] += 1
    collective_stats["bytes"] += stats["bytes_sent"]
    LAST_EXCHANGE_STATS.update(stats)
    return out


def _exchange_on(arrays: dict, dest: np.ndarray, tag: str, group) -> tuple[dict, dict, tuple]:
    """``exchange_rows``' transport on ``group`` (None: the default
    group): (the rows received, the exchange's stats, the (send, receive)
    byte tensors)."""
    p = process_count()
    keys = sorted(arrays)
    for k in keys:
        if len(arrays[k]) != len(dest):
            raise ValueError(f"exchange {tag!r}: array {k!r} has {len(arrays[k])} rows, dest {len(dest)}")
    if len(dest) and (dest.min() < 0 or dest.max() >= p):
        raise ValueError(f"exchange {tag!r}: destinations outside [0, {p})")
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=p).astype(np.int64)
    # (source, destination) row counts
    matrix = np.stack([g[0] for g in _gather_arrays([counts], group)])
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
                           input_split_sizes=[int(c) * width for c in counts], group=group)
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
# the overlapped exchange schedule (PHOTON_RE_SHARD=1)
# ---------------------------------------------------------------------------
# An exchange is issued at one program point and joined at a later one,
# with solves, host work and collectives of the main thread in between.
# Its body runs on one worker thread per process, in submission order,
# over a second gloo group that no other code uses: every process submits
# the same exchanges in the same order, so the worker's collectives pair
# across processes, and they never interleave with the main thread's on
# the default group (two threads issuing collectives on one group could
# pair them in different orders on different processes). The group is
# created collectively on the calling thread at the first exchange, in
# program order.
_ASYNC: dict = {"group": None, "pool": None}
_EXCHANGE_LOCK = threading.Lock()  # the pending list and the overlap books
_PENDING_EXCHANGES: list = []
_EXCHANGE_TOTALS = {"exchange_s": 0.0, "wait_s": 0.0}


def _exchange_group():
    if _ASYNC["group"] is None:
        _ASYNC["group"] = dist.new_group(backend=BACKEND, timeout=timedelta(seconds=_TIMEOUT_S[0]))
    if _ASYNC["pool"] is None:
        _ASYNC["pool"] = ThreadPoolExecutor(max_workers=1, thread_name_prefix="photon-exchange")
    return _ASYNC["group"], _ASYNC["pool"]


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


class ExchangeHandle:
    """A pending ``exchange_rows_async``. ``result()`` blocks until the
    rows land and returns ``exchange_rows``' dict, or what the epilogue
    ``finish(rows, stats)`` makes of it. The first call joins, under a
    lock, so any thread may join (a prefetch worker, the main thread) and
    the epilogue runs once; later calls return the same value. The blocked
    seconds go to ``re_exchange.wait_s`` (and an ``exchange_wait`` record
    while a sink is on). ``stats`` holds the exchange's
    ``LAST_EXCHANGE_STATS`` keys, its ``seconds`` on the worker and the
    joiner's ``wait_s`` once it has been joined."""

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
                        with _EXCHANGE_LOCK:
                            _PENDING_EXCHANGES[:] = [e for e in _PENDING_EXCHANGES if e[0] is not self._future]
                    self.stats = dict(stats, wait_s=waited)
                self._value = out if self._finish is None else self._finish(out, self.stats)
                self._future = self._finish = None
                self._joined = True
            return self._value


def exchange_rows_async(arrays, dest: np.ndarray, tag: str = "", finish=None) -> ExchangeHandle:
    """``exchange_rows`` without blocking: a handle whose ``result()`` is
    the same dict (or ``finish(rows, stats)`` of it). The rows travel on the exchange worker over the second
    gloo group (created here, collectively, at the first call). Every
    process calls it at the same program point; the arrays must not change
    until the handle is joined. On one process it completes inline (the
    identity), recording zero seconds so the overlap gauge exists there
    too."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    dest = np.asarray(dest, np.int64).reshape(-1)
    if process_count() <= 1:
        _record_overlap("exchange_s", 0.0)
        _record_overlap("wait_s", 0.0)
        return ExchangeHandle(value=arrays, finish=finish, stats=dict(
            bytes_sent=0, rows_sent=len(dest), padded_rows=len(dest), transport="local", seconds=0.0, wait_s=0.0))
    group, pool = _exchange_group()

    def run():
        t0 = time.perf_counter()
        try:
            out, stats, _ = _exchange_on(arrays, dest, tag, group)
        finally:
            dur = time.perf_counter() - t0
            _record_overlap("exchange_s", dur)
            emit_event("exchange", tag=tag, dur_s=dur)
        return out, dict(stats, transport=f"{BACKEND}_async", seconds=dur)

    fut = pool.submit(run)
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.append((fut, tag))
    return ExchangeHandle(future=fut, tag=tag, finish=finish)



def _allgather_bytes_exact(payload: bytes, group) -> tuple[list[bytes], int]:
    """Every process's ``payload`` in rank order, each sent to every other
    process at its own size (one all_to_all over the sizes' gather, no
    padding to the largest). Returns the payloads and the bytes this
    process sent."""
    p, me = process_count(), process_index()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(p)]
    dist.all_gather(sizes, torch.tensor([len(payload)], dtype=torch.int64), group=group)
    sizes = [int(x) for x in sizes]
    n = len(payload)
    send = torch.frombuffer(bytearray(payload * (p - 1)), dtype=torch.uint8) if n and p > 1 \
        else torch.zeros(0, dtype=torch.uint8)
    recv = torch.empty(sum(sz for q, sz in enumerate(sizes) if q != me), dtype=torch.uint8)
    dist.all_to_all_single(recv, send, output_split_sizes=[0 if q == me else sizes[q] for q in range(p)],
                           input_split_sizes=[0 if q == me else n for q in range(p)], group=group)
    raw, out, pos = recv.numpy(), [], 0
    for q in range(p):
        if q == me:
            out.append(payload)
            continue
        out.append(raw[pos:pos + sizes[q]].tobytes())
        pos += sizes[q]
    return out, n * (p - 1)


def allgather_bytes_async(payload: bytes, tag: str = "", stats: dict | None = None) -> ExchangeHandle:
    """Every process's ``payload`` in rank order, without blocking: a
    handle whose ``result()`` is the list. It travels like
    ``exchange_rows_async``'s rows, on the exchange worker over the second
    gloo group, each payload sent at its own size to every other process.
    ``stats`` (when given) receives ``bytes_sent`` (this process's payload
    times P - 1) and ``exchange_s`` (the seconds on the worker). On one
    process it completes inline."""
    stats = {} if stats is None else stats
    if process_count() <= 1:
        stats.update(bytes_sent=0, exchange_s=0.0)
        return ExchangeHandle(value=[payload], tag=tag, stats=stats)
    group, pool = _exchange_group()

    def run():
        t0 = time.perf_counter()
        try:
            blobs, sent = _allgather_bytes_exact(payload, group)
        finally:
            dur = time.perf_counter() - t0
            emit_event("exchange", tag=tag, dur_s=dur)
        stats.update(bytes_sent=sent, exchange_s=dur)
        return blobs, dict(stats)

    fut = pool.submit(run)
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.append((fut, tag))
    return ExchangeHandle(future=fut, tag=tag)

def drain_async_exchanges() -> None:
    """Wait for every exchange in flight (each result stays claimable
    through its handle, which re-raises a failure). The streamed trainer
    drains before a checkpoint, a re-plan and the fit's end."""
    with _EXCHANGE_LOCK:
        pending = list(_PENDING_EXCHANGES)
    for fut, _ in pending:
        fut.exception()  # waits; the handle's result() re-raises


def _reset_async_exchanges() -> None:
    """Drain, stop the worker and forget the group (before the process
    group it belongs to is destroyed)."""
    drain_async_exchanges()
    if _ASYNC["pool"] is not None:
        _ASYNC["pool"].shutdown(wait=True)
    _ASYNC.update(group=None, pool=None)
    with _EXCHANGE_LOCK:
        _PENDING_EXCHANGES.clear()
        _EXCHANGE_TOTALS.update(exchange_s=0.0, wait_s=0.0)
