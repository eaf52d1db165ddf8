"""Chrome-trace / Perfetto export of a telemetry run (own copy of
``photon_ml_tpu/obs/export.py``).

Renders a run's span records as Chrome trace-event JSON (the
``{"traceEvents": [...]}`` container), so the host's span timeline opens
in Perfetto or ``chrome://tracing`` beside the ``torch.profiler`` traces
the drivers write under ``--profile-dir``.

Mapping: every ``span`` record becomes a complete event (``"ph": "X"``,
micro-second ``ts`` / ``dur`` from ``run_start``); ``log`` and optimizer
records become instant events (``"ph": "i"``). Thread ids map to ``tid``
with thread-name metadata, so the prefetch workers render as their own
tracks.

Fleet runs: ``fleet_chrome_trace`` merges every file of one run (process
0's canonical file and the ``.p<k>`` shards) into one trace on a shared
time base (``pid`` = process index). ``export_chrome_trace`` takes a run
file, a list of shard files, or a telemetry directory (every file of its
newest canonical run).
"""

from __future__ import annotations

import json
import os
from typing import Any


def chrome_trace(
    records: list[dict],
    pid: int | None = None,
    t0: float | None = None,
) -> dict:
    """Chrome trace-event JSON (as a dict) for one run's records.
    ``pid``/``t0`` override the run's own process index / start time —
    the fleet merge pins every shard to one shared time base."""
    for r in records:
        if r.get("event") == "run_start":
            if t0 is None:
                t0 = float(r["t"])
            if pid is None:
                pid = int(r.get("process_index", 0))
            break
    if t0 is None and records:
        t0 = min(float(r["t"]) for r in records if "t" in r)
    t0 = t0 or 0.0
    pid = pid or 0

    events: list[dict[str, Any]] = []
    thread_names: dict[int, str] = {}

    def us(t: float) -> float:
        return max((t - t0) * 1e6, 0.0)

    for r in records:
        kind = r.get("event")
        if kind == "span":
            tid = int(r.get("tid") or 0)
            if r.get("thread") and tid not in thread_names:
                thread_names[tid] = r["thread"]
            ev: dict[str, Any] = {
                "name": r.get("name", "span"),
                "ph": "X",
                "ts": us(float(r["t"])),
                "dur": float(r.get("dur_s", 0.0)) * 1e6,
                "pid": pid,
                "tid": tid,
            }
            args = dict(r.get("attrs") or {})
            args["span_id"] = r.get("span_id")
            if r.get("parent_id") is not None:
                args["parent_id"] = r["parent_id"]
            ev["args"] = args
            events.append(ev)
        elif kind in ("log", "optim_iter", "optim_result", "jax_event",
                      "p2p_send", "p2p_recv", "p2p_heartbeat",
                      "exchange", "exchange_wait"):
            name = (
                r.get("message") if kind == "log" else r.get("name", kind)
            ) or kind
            events.append(
                {
                    "name": str(name)[:120],
                    "ph": "i",
                    "s": "t",
                    "ts": us(float(r["t"])),
                    "pid": pid,
                    "tid": int(r.get("tid") or 0),
                    "args": {
                        k: v
                        for k, v in r.items()
                        if k not in ("event", "t") and _plain(v)
                    },
                }
            )
    for tid, name in thread_names.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _plain(v) -> bool:
    return isinstance(v, (str, int, float, bool)) or v is None


def fleet_chrome_trace(records_by_shard: list[list[dict]]) -> dict:
    """One merged trace for every shard of a fleet run: a shared time
    base (the earliest shard's ``run_start``), ``pid`` = each shard's
    process index, plus ``process_name`` metadata so the Perfetto UI
    labels the swim-lane groups."""
    t0 = None
    for records in records_by_shard:
        for r in records:
            if r.get("event") == "run_start":
                t = float(r["t"])
                t0 = t if t0 is None else min(t0, t)
                break
    events: list[dict[str, Any]] = []
    for records in records_by_shard:
        pid = 0
        for r in records:
            if r.get("event") == "run_start":
                pid = int(r.get("process_index", 0))
                break
        events.extend(chrome_trace(records, pid=pid, t0=t0)["traceEvents"])
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"process {pid}"},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(
    jsonl_path: str | list[str], out_path: str | None = None
) -> dict:
    """Read a run (file), a fleet run (list of shard files, or a
    telemetry DIRECTORY — all shards of the newest canonical run) and
    return (optionally write) its Chrome trace. A directory or list
    with a single file degrades to the plain single-process trace."""
    from photon_ml_tpu_torch.obs.report import fleet_run_paths, load_run

    if isinstance(jsonl_path, str) and os.path.isdir(jsonl_path):
        jsonl_path = fleet_run_paths(jsonl_path)
    if isinstance(jsonl_path, (list, tuple)):
        if len(jsonl_path) == 1:
            trace = chrome_trace(load_run(jsonl_path[0]))
        else:
            trace = fleet_chrome_trace(
                [load_run(p) for p in jsonl_path]
            )
    else:
        trace = chrome_trace(load_run(jsonl_path))
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(trace, f)
    return trace
