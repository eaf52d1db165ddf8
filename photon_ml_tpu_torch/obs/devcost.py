"""Analytic device cost at the kernel launchers, and the card's memory axis
(the port's counterpart of ``photon_ml_tpu/obs/devcost.py``).

The reference lowers and compiles a jitted executable a second time to read
XLA's flops and bytes. The port has no executables: its kernels are CUDA
functions launched from ``ops/fused.py`` (K1, K2) and
``ops/sparse_tiled.py`` (K3). So it captures at those launchers, and the
counts are analytic, from the shapes and dtypes of the call: the bytes the
kernel must move (each input read once, each output written once) and the
operations it does, the same counts a roofline bound divides. The record
is the reference's ``executable_cost``, field for field, so a reader holds
a kernel's time against the same work whatever implements it.

Capture discipline:

- **Once per key.** A process-wide seen-set keyed by ``(label, knob tuple,
  argument signature)``: the knob tuple is the run's knobs
  (``sink._knob_snapshot``, memoized on its raw inputs), the signature the
  shape and dtype of every tensor argument and the repr of every other.
  A repeat call emits nothing and costs the signature's build and one set
  lookup.
- **Gated.** On while a sink is active; ``PHOTON_DEVCOST=1`` forces it on
  without a sink (registry gauges only), ``=0`` forces it off. Capture
  reads nothing from the card and synchronizes nothing.
- **Never fatal.** A failure counts ``devcost.capture_errors`` and the run
  goes on.

The memory axis: ``sample_hbm_watermarks`` (at every root span's exit)
reads ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` /
``.peak``) and ``torch.cuda.mem_get_info`` on each visible card, and emits
one ``available: false`` record on a machine without CUDA, so a reader
tells "no pressure" from "no instrument". ``record_hbm_budget`` (called by
``ops/streaming.device_hbm_budget_bytes``) and ``record_layout_pack``
(called by ``ops/tile_cache`` when it packs K3 layouts) are the
reference's.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Callable

from photon_ml_tpu_torch.obs import metrics as _metrics
from photon_ml_tpu_torch.obs import sink as _sink_mod

COST_SCHEMA_VERSION = 1

_lock = threading.Lock()
_seen: set[tuple] = set()
# once-per-sink emission guards (a new sink is a new run)
_budget_sink: Any = None
_wm_unavailable_sink: Any = None
# root spans include the prefetch workers' per-chunk spans: a watermark at
# sub-second cadence is noise
_WM_MIN_INTERVAL_S = 0.5
_last_wm_sample = [float("-inf")]


def reset() -> None:
    """Forget captured signatures and the once-per-run state (tests)."""
    global _budget_sink, _wm_unavailable_sink
    with _lock:
        _seen.clear()
        _label_totals.clear()
        _budget_sink = None
        _wm_unavailable_sink = None
        _last_wm_sample[0] = float("-inf")


_warned_bad_env = [False]


def capture_enabled() -> bool:
    """``PHOTON_DEVCOST`` wins (an int: ``1`` on without a sink, ``0``
    off), else capture exactly while a sink is active. A malformed value
    turns capture off with one warning: this check sits on every kernel
    launch, and a telemetry typo must not take the run down."""
    env = os.environ.get("PHOTON_DEVCOST")
    if env is not None and env != "":
        try:
            return bool(int(env))
        except ValueError:
            if not _warned_bad_env[0]:
                _warned_bad_env[0] = True  # a benign race: at worst a second warning
                import warnings

                warnings.warn(
                    f"PHOTON_DEVCOST={env!r} is not an int; device-cost capture disabled (use 1/0)",
                    stacklevel=2,
                )
            return False
    return _sink_mod.is_active()


# the knob snapshot memoized on its raw inputs (the environment variables
# and module globals ``sink._knob_snapshot`` reads): a knob flip is seen at
# once. A knob added to the snapshot must be added here too.
_knob_memo: list = []  # [raw fingerprint, knobs, sorted item tuple]


def _knob_raw_state() -> tuple:
    import photon_ml_tpu_torch.data.index_map as im
    import photon_ml_tpu_torch.game.projector as proj
    import photon_ml_tpu_torch.game.random_effect as re_mod
    import photon_ml_tpu_torch.ops.prefetch as pf
    import photon_ml_tpu_torch.ops.sparse_tiled as st
    import photon_ml_tpu_torch.ops.stream_executor as se
    import photon_ml_tpu_torch.parallel.placement as pl
    import photon_ml_tpu_torch.serve.refresh as sv_refresh
    import photon_ml_tpu_torch.serve.router as sv_router
    import photon_ml_tpu_torch.serve.store as sv_store

    env = os.environ
    return (
        env.get("PHOTON_PREFETCH_DEPTH"), env.get("PHOTON_CHUNK_CACHE_BUDGET"),
        env.get("PHOTON_KERNEL_DTYPE"), env.get("PHOTON_DISABLE_FUSED"),
        len(pf._device_budget_memo), st.KERNEL_DTYPE, st.TILE_NNZ,
        env.get("PHOTON_RE_COMPACT_EVERY"), env.get("PHOTON_RE_FUSE_BUCKETS"), env.get("PHOTON_RE_PROJECT"),
        env.get("PHOTON_RE_PROJECT_DIM"), env.get("PHOTON_RE_SHARD"), re_mod.COMPACT_EVERY, re_mod.FUSE_BUCKETS,
        proj.RE_PROJECT, proj.RE_PROJECT_DIM, pl.RE_SHARD,
        env.get("PHOTON_RE_COMBINE"), env.get("PHOTON_RE_SPLIT"), env.get("PHOTON_RE_DEVICE_SPLIT"),
        env.get("PHOTON_RE_SPLIT_WEIGHT"), re_mod.RE_COMBINE, pl.RE_SPLIT, pl.RE_DEVICE_SPLIT, pl.RE_SPLIT_WEIGHT,
        env.get("PHOTON_FE_SHARD"), env.get("PHOTON_FE_SPLIT_WEIGHT"), im.FE_SHARD, im.FE_SPLIT_WEIGHT,
        env.get("PHOTON_RE_REPLAN_IMBALANCE"), pl.REPLAN_IMBALANCE,
        env.get("PHOTON_SERVE_HOT_BYTES"), env.get("PHOTON_SERVE_MAX_BATCH"), env.get("PHOTON_SERVE_MAX_WAIT_MS"),
        env.get("PHOTON_SERVE_REFRESH_EVERY"), sv_store.SERVE_HOT_BYTES, sv_router.SERVE_MAX_BATCH,
        sv_router.SERVE_MAX_WAIT_MS, sv_refresh.SERVE_REFRESH_EVERY,
        env.get("PHOTON_STREAM_EXECUTOR"), env.get("PHOTON_STREAM_PRIORITY"), env.get("PHOTON_STREAM_SHARE"),
        se.STREAM_EXECUTOR, se.STREAM_PRIORITY, se.STREAM_SHARE,
    )


def _knob_items() -> tuple:
    fp = _knob_raw_state()
    memo = _knob_memo
    if memo and memo[0] == fp:
        return memo[2]
    knobs = _sink_mod._knob_snapshot()
    items = tuple(sorted(knobs.items()))
    _knob_memo[:] = [fp, knobs, items]  # lock-free: a racing rewrite stores the same value
    return items


def knob_key() -> dict:
    """The knobs a kernel ran under: the snapshot a run's ``run_start``
    records."""
    return dict(_knob_items())


def _descriptors(args) -> tuple:
    """Hashable per-argument signature: shape and dtype of a tensor or
    array, repr of anything else."""
    parts = []
    for a in args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            parts.append(f"{tuple(a.shape)}:{a.dtype}")
        else:
            parts.append(repr(a))
    return tuple(parts)


def capture(label: str, args: tuple, cost: Callable[[], dict], **extra) -> dict | None:
    """Record a kernel's analytic cost for this (label, knobs, argument
    signature) if it was not recorded before. ``cost()`` runs on a miss
    only and returns ``flops``, ``bytes_accessed`` and, optionally,
    ``memory`` (``argument_size_in_bytes`` / ``output_size_in_bytes`` /
    ``temp_size_in_bytes``; the peak is estimated as their sum and
    flagged). Returns the record, or None when disabled, already seen or
    on any failure."""
    if not capture_enabled():
        return None
    try:
        sig_tuple = _descriptors(args)
        key = (label, _knob_items(), sig_tuple)
        with _lock:
            if key in _seen:
                return None
            _seen.add(key)  # before computing: a failing capture is not retried every call
        t0 = time.perf_counter()
        c = cost()
        capture_s = time.perf_counter() - t0
        flops, bytes_accessed = float(c["flops"]), float(c["bytes_accessed"])
        mem = dict(c.get("memory") or {})
        peak = None
        if mem:
            peak = (mem.get("argument_size_in_bytes", 0) + mem.get("output_size_in_bytes", 0)
                    + mem.get("temp_size_in_bytes", 0))
        record = {
            "event": "executable_cost",
            "cost_schema_version": COST_SCHEMA_VERSION,
            "label": label,
            "knobs": knob_key(),
            "arg_sig": hashlib.sha256("|".join(sig_tuple).encode()).hexdigest()[:16],
            "flops": flops,
            "bytes_accessed": bytes_accessed,
            "arith_intensity": flops / bytes_accessed if bytes_accessed else None,
            "memory": mem,
            "peak_bytes": peak,
            "peak_is_estimate": peak is not None,
            "capture_s": capture_s,
        }
        record.update(extra)
        _publish(record)
        return record
    except Exception:
        try:
            _metrics.REGISTRY.counter_inc("devcost.capture_errors")
        except Exception:
            pass
        return None


# per-label running totals behind the devcost.<label>.* gauges: one label
# captures several signatures (chunk shapes, widths), so the gauges carry
# the sum of flops and bytes and the largest peak, as the reference's do
_label_totals: dict[str, list] = {}


def _publish(record: dict) -> None:
    reg = _metrics.REGISTRY
    label = record["label"]
    reg.counter_inc("devcost.captures")
    reg.timer_add("devcost.capture_s", record["capture_s"])
    with _lock:
        tot = _label_totals.setdefault(label, [0.0, 0.0, 0])
        tot[0] += record["flops"]
        tot[1] += record["bytes_accessed"]
        if record["peak_bytes"] is not None:
            tot[2] = max(tot[2], record["peak_bytes"])
        flops_t, bytes_t, peak_t = tot
    reg.gauge_set(f"devcost.{label}.flops", flops_t)
    reg.gauge_set(f"devcost.{label}.bytes_accessed", bytes_t)
    if peak_t:
        reg.gauge_set(f"devcost.{label}.peak_bytes", peak_t)
    from photon_ml_tpu_torch.obs.spans import emit_event

    emit_event("executable_cost", **{k: v for k, v in record.items() if k != "event"})


# -- the runtime memory axis -----------------------------------------------------------
def record_hbm_budget(budget_bytes: float, queried: bool) -> None:
    """Called by ``ops/streaming.device_hbm_budget_bytes`` on every query:
    the gauges always, and one ``hbm_budget`` event per sink naming the
    source (the card's memory, or the caller's default without CUDA)."""
    global _budget_sink
    try:
        reg = _metrics.REGISTRY
        reg.gauge_set("hbm.budget_bytes", float(budget_bytes))
        reg.gauge_set("hbm.budget_queried", 1.0 if queried else 0.0)
        s = _sink_mod.active_sink()
        if s is not None and s is not _budget_sink:
            _budget_sink = s
            from photon_ml_tpu_torch.obs.spans import emit_event

            emit_event("hbm_budget", budget_bytes=float(budget_bytes),
                       source="device_memory_stats" if queried else "fallback_default")
    except Exception:
        pass


def _card_memory() -> list[dict]:
    """Each visible card's allocator watermarks and free memory; empty
    without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": str(i),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "bytes_free": int(free),
        })
    return out


def sample_hbm_watermarks(root_span: str | None = None) -> dict | None:
    """Sample the cards' memory at a root span's exit: one ``hbm_watermark``
    record (``available: false`` once per sink without CUDA) and
    largest-over-cards gauges; returns the record, or None when nothing
    was sampled. Samples closer than ``_WM_MIN_INTERVAL_S`` apart are
    skipped (the peak is cumulative, so only the instantaneous figure is
    lost). It reads the allocator's counters and ``cudaMemGetInfo``, and
    launches nothing."""
    global _wm_unavailable_sink
    s = _sink_mod.active_sink()
    now = time.monotonic()
    with _lock:
        if now - _last_wm_sample[0] < _WM_MIN_INTERVAL_S:
            return None
        _last_wm_sample[0] = now
    try:
        per_device = _card_memory()
        from photon_ml_tpu_torch.obs.spans import emit_event

        if not per_device:
            if s is not None and s is not _wm_unavailable_sink:
                _wm_unavailable_sink = s
                rec = {"available": False, "root_span": root_span}
                emit_event("hbm_watermark", **rec)
                return rec
            return None
        reg = _metrics.REGISTRY
        in_use = max(d["bytes_in_use"] for d in per_device)
        peak = max(d["peak_bytes_in_use"] for d in per_device)
        reg.gauge_set("hbm.bytes_in_use", float(in_use))
        reg.gauge_set("hbm.peak_bytes_in_use", float(peak))
        rec = {"available": True, "root_span": root_span, "bytes_in_use": in_use,
               "peak_bytes_in_use": peak, "devices": per_device}
        if s is not None:
            emit_event("hbm_watermark", **rec)
        return rec
    except Exception:
        return None


def record_layout_pack(nbytes: int, chunks: int) -> None:
    """Called by ``ops/tile_cache`` when a miss packs K3 layouts: the
    packed streams are the kernel's memory traffic, so the packed bytes per
    storage rung are the analytic half of the rung's bytes-moved claim."""
    try:
        reg = _metrics.REGISTRY
        reg.counter_inc("devcost.tile_layout.packs")
        reg.counter_inc("devcost.tile_layout.packed_bytes_total", nbytes)
        reg.gauge_set("devcost.tile_layout.packed_bytes", float(nbytes))
        if _sink_mod.is_active():
            from photon_ml_tpu_torch.obs.spans import emit_event

            emit_event("tile_layout_pack", nbytes=int(nbytes), chunks=int(chunks), knobs=knob_key())
    except Exception:
        pass
