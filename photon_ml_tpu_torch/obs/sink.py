"""Buffered JSONL event sink: one run, one schema-versioned file (port of
``photon_ml_tpu/obs/sink.py``).

Every span, optimizer record, structured warning and metric snapshot of a
run lands as one JSON line in one file, which ``obs.report``
(``photon-ml-tpu-torch report``) summarizes, diffs and gates and
``obs.export`` exports: the record kinds, field names and
``SCHEMA_VERSION`` are the reference's, letter for letter, so the
reference's ``photon-ml-tpu report`` reads the same file.

Durability: the file on disk is always a complete, parseable run prefix.
Buffered records are committed by atomic rotation: the accumulated content
is written to a temp file in the same directory, fsync'd and renamed over
the run file (``utils/atomic_io``), so a reader never sees a torn tail and
a crash never shadows a complete file with a partial one. The rotation
threshold grows with the file (bounded at ``_MAX_ROTATE_EVERY``), so the
total bytes written stay O(n log n).

Across processes: process 0 writes the canonical ``run-<id>.jsonl``. Under
fleet telemetry (``PHOTON_TELEMETRY_FLEET=1``) every other process writes
its own shard ``run-<id>.p<k>.jsonl`` under the same durability rule, with
the same run id (process 0's, broadcast over the process group). Without
it, ``configure`` on a process other than 0 returns a disabled sink: one
process writes, as it does the models.

With no sink configured, ``emit`` is never reached: every ``span()``
returns a shared no-op and ``emit_event`` is one attribute check, so the
instrumentation stays wired through the production paths.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any

from photon_ml_tpu_torch.obs import metrics as _metrics

SCHEMA_VERSION = 1

# rotation cadence: the first commit after this many buffered records, then
# in proportion to what is already written
_FIRST_ROTATE_EVERY = 128
_MAX_ROTATE_EVERY = 65536


def _json_default(o: Any) -> str:
    return str(o)


def _sanitize(v: Any) -> Any:
    """Strict-JSON record values: ``json`` writes bare ``NaN`` /
    ``Infinity`` (a diverged solve's loss), which strict parsers (the
    Perfetto UI, any non-Python reader) reject for the whole file.
    Non-finite floats become strings."""
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "Infinity"
        if v == float("-inf"):
            return "-Infinity"
        return v
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


class TelemetrySink:
    """One run's JSONL file. Thread-safe; records are buffered and
    committed by atomic rotation (never an append a crash could tear)."""

    _seq = itertools.count()  # runs of one process in one second stay distinct

    def __init__(self, directory: str, run_id: str | None = None, shard_index: int | None = None):
        os.makedirs(directory, exist_ok=True)
        self.run_id = run_id or (time.strftime("%Y%m%dT%H%M%S") + f"-{os.getpid()}-{next(self._seq)}")
        self.directory = directory
        # shard_index k > 0: one process's slice of a fleet run, beside
        # process 0's canonical file (which keeps its name)
        self.shard_index = shard_index
        suffix = f".p{shard_index}" if shard_index else ""
        self.path = os.path.join(directory, f"run-{self.run_id}{suffix}.jsonl")
        self._lock = threading.Lock()
        self._lines: list[str] = []
        self._pending = 0
        self._rotate_every = _FIRST_ROTATE_EVERY
        self._closed = False

    def emit(self, record: dict) -> None:
        """Buffer one record (a plain dict; a value JSON cannot hold is
        written as its ``str``: telemetry never takes down the run it
        observes)."""
        line = json.dumps(_sanitize(record), default=_json_default)
        with self._lock:
            if self._closed:
                return
            self._lines.append(line)
            self._pending += 1
            if self._pending >= self._rotate_every:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        from photon_ml_tpu_torch.utils.atomic_io import atomic_replace_bytes

        data = ("\n".join(self._lines) + "\n").encode()
        atomic_replace_bytes(self.directory, self.path, data)
        self._pending = 0
        self._rotate_every = min(max(_FIRST_ROTATE_EVERY, len(self._lines)), _MAX_ROTATE_EVERY)

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._rotate_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._rotate_locked()
            self._closed = True


# -- the process-wide active sink -----------------------------------------------------
_ACTIVE: TelemetrySink | None = None
_state_lock = threading.Lock()


def active_sink() -> TelemetrySink | None:
    return _ACTIVE


def is_active() -> bool:
    """Whether a sink is configured (cheap and lock-free: callers gate
    observability-only read-backs on it)."""
    return _ACTIVE is not None


def _process_index() -> int:
    # the original index: a shard keeps its name after the group degrades
    from photon_ml_tpu_torch.parallel import multihost

    return multihost.original_process_index()


def _process_count() -> int:
    from photon_ml_tpu_torch.parallel import multihost

    return multihost.original_process_count()


def fleet_telemetry_enabled() -> bool:
    """``PHOTON_TELEMETRY_FLEET`` (a strict int parse: a typo raises).
    Unset, it follows ``PHOTON_RE_SHARD``, as the reference's does: the
    entity-sharded schedule is the workload whose telemetry lives on
    processes 1..N-1, and every other multi-process run keeps one file."""
    env = os.environ.get("PHOTON_TELEMETRY_FLEET")
    if env is not None and env != "":
        return int(env) != 0
    from photon_ml_tpu_torch.parallel.placement import re_shard_enabled

    return re_shard_enabled()


def _fleet_run_id() -> str:
    """One run id for every process of a fleet run: process 0's, broadcast
    (the shards must carry the canonical file's id to be joined with it).
    A collective: every process reaches ``configure`` at the same program
    point, as the drivers call it after the process group is up."""
    import numpy as np

    from photon_ml_tpu_torch.parallel.multihost import broadcast_from_host0

    rid = time.strftime("%Y%m%dT%H%M%S") + f"-{os.getpid()}"
    buf = np.zeros(64, np.uint8)
    raw = rid.encode()[:64]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.asarray(broadcast_from_host0(buf), np.uint8)
    return bytes(out[out != 0]).decode()


def configure(telemetry_dir: str | None, run_id: str | None = None,
              force_writer: bool | None = None) -> str | None:
    """Enable telemetry into ``telemetry_dir`` and return the run file's
    path; ``None`` leaves it disabled (the drivers call this with their
    ``--telemetry-dir`` whatever it is). Across processes process 0 writes
    the canonical file; under fleet telemetry every other process writes
    its ``.p<k>`` shard, else it gets a disabled sink unless
    ``force_writer=True``. Configuring again closes the previous run's sink
    first."""
    global _ACTIVE
    with _state_lock:
        if _ACTIVE is not None:
            _shutdown_locked()
        if telemetry_dir is None:
            return None
        pidx = _process_index()
        fleet = _process_count() > 1 and fleet_telemetry_enabled()
        if fleet and run_id is None and force_writer is None:
            run_id = _fleet_run_id()  # collective: the shards' join id
        writer = force_writer if force_writer is not None else pidx == 0
        shard_index = None
        if not writer:
            if not fleet:
                return None
            shard_index = pidx
        sink = TelemetrySink(telemetry_dir, run_id=run_id, shard_index=shard_index)
        record = {
            "event": "run_start",
            "t": time.time(),
            "schema_version": SCHEMA_VERSION,
            "run_id": sink.run_id,
            "pid": os.getpid(),
            "process_index": pidx,
            "knobs": _knob_snapshot(),
            # the registry is process-cumulative: the baseline lets a
            # reader subtract what earlier runs of the process counted
            "metrics_baseline": _metrics.REGISTRY.snapshot(),
        }
        if fleet:
            record["fleet"] = {"process_count": _process_count()}
        sink.emit(record)
        _ACTIVE = sink
        return sink.path


def shutdown() -> None:
    """Emit the ``run_end`` record (with the registry's snapshot), commit
    the file and disable the sink. Safe when already disabled."""
    with _state_lock:
        _shutdown_locked()


def _shutdown_locked() -> None:
    global _ACTIVE
    sink = _ACTIVE
    _ACTIVE = None  # disable emission first: closing must not race new spans
    if sink is None:
        return
    record = {
        "event": "run_end",
        "t": time.time(),
        "run_id": sink.run_id,
        "metrics": _metrics.REGISTRY.snapshot(),
    }
    try:
        from photon_ml_tpu_torch.ops import prefetch

        record["chunk_cache"] = prefetch.cache_stats()
    except Exception:
        pass
    sink.emit(record)
    sink.close()


def _knob_snapshot() -> dict:
    """The port's knobs a run executed under, so two runs' files diff as
    configurations too: the prefetch depth, the chunk cache's budget, the
    kernels' storage rung (``PHOTON_KERNEL_DTYPE``), whether K1 and K2 run
    (``PHOTON_DISABLE_FUSED``), K1's layout rule (the widths up to which
    it takes the tiles layout), K3's tile size, and the random-effect
    knobs under the reference's names (the schedule knobs, the projection,
    entity sharding, the split, its weight, the device split and the
    combine), and the fixed effect's feature-range sharding and its
    split axis."""
    knobs: dict = {}
    try:
        from photon_ml_tpu_torch.ops import prefetch

        knobs["prefetch_depth"] = prefetch.prefetch_depth()
        knobs["chunk_cache_budget_bytes"] = int(prefetch.chunk_cache_budget_bytes())
    except Exception:
        pass
    try:
        from photon_ml_tpu_torch.ops import sparse_tiled as st

        knobs["kernel_dtype"] = st.kernel_dtype()
        knobs["k3_tile_nnz"] = int(st.TILE_NNZ)
    except Exception:
        pass
    try:
        import torch

        from photon_ml_tpu_torch.ops import fused
        from photon_ml_tpu_torch.ops.glm import fused_disabled

        knobs["fused"] = int(not fused_disabled())
        knobs["k1_tiles_max_features_f32"] = int(fused.TILES_MAX_FEATURES[torch.float32])
        knobs["k1_tiles_max_features_bf16"] = int(fused.TILES_MAX_FEATURES[torch.bfloat16])
    except Exception:
        pass
    try:
        from photon_ml_tpu_torch.game import random_effect as re_mod

        knobs["re_compact_every"] = int(re_mod.compact_every())
        knobs["re_fuse_buckets"] = int(bool(re_mod.fuse_buckets()))
        knobs["re_combine"] = str(re_mod.re_combine_mode())
    except Exception:
        pass
    try:
        from photon_ml_tpu_torch.game import projector

        knobs["re_project"] = str(projector.re_project_mode())
        knobs["re_project_dim"] = int(projector.re_project_dim())
    except Exception:
        pass
    try:
        from photon_ml_tpu_torch.parallel import placement

        knobs["re_shard"] = int(bool(placement.re_shard_enabled()))
        knobs["re_split"] = int(placement.re_split_factor())
        knobs["re_device_split"] = int(bool(placement.re_device_split_enabled()))
        knobs["re_split_weight"] = str(placement.re_split_weight())
    except Exception:
        pass
    try:
        from photon_ml_tpu_torch.data import index_map

        knobs["fe_shard"] = int(bool(index_map.fe_shard_enabled()))
        knobs["fe_split_weight"] = str(index_map.fe_split_weight())
    except Exception:
        pass
    return knobs
