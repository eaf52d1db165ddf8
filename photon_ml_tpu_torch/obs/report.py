"""Run-report rendering: load, validate, summarize, diff and gate
telemetry runs (port of ``photon_ml_tpu/obs/report.py``).

The ``photon-ml-tpu-torch report`` command's engine. A summary answers the
question every on-chip sweep needs answered per run — where did the wall
go (per-phase span seconds), how much was kernel build, how much was
host→device transfer, what did the optimizers do — and ``diff`` lines two
runs up so a knob sweep (``PHOTON_PREFETCH_DEPTH``, …) reads as a table
instead of two log greps. Phases are the first ``/`` segment of span
names (``descent/iter`` → ``descent``); a phase's wall is the UNION of its
phase-entry spans' time intervals (entry = parent outside the phase), so
neither nesting nor concurrent worker-thread spans double-count. Phases
may still overlap EACH OTHER in wall time — a prefetch worker's
``ingest`` span running under a consumer's ``cv`` span is real
pipelining, so the phase column can legitimately sum past the run's wall.

The record kinds, registry names, summary keys, fleet view and gate
metrics are the reference's, so either package's report reads either
package's runs and the two agree, with one decided difference:
``compile_s`` (and the gate metric of that name) is the port's kernel
build timer ``cuda.build_s``, the counterpart of the reference's XLA
compile events and ``jax.compile_s`` timer, which the port never writes.
Sections for names the port does not emit yet (online serving
``serve.*``, the stream executor's ``stream.cache.*``) render only when
their names are present, as in the reference.
"""

from __future__ import annotations

import json
import os
import re

from photon_ml_tpu_torch.obs.sink import SCHEMA_VERSION

# fleet shard files: run-<id>.p<k>.jsonl (processes 1..N-1 of one run,
# next to process 0's canonical run-<id>.jsonl)
_SHARD_RE = re.compile(r"\.p(\d+)\.jsonl$")

_SPAN_REQUIRED = ("name", "span_id", "dur_s", "t")


def load_run(path: str) -> list[dict]:
    """Parse one run's JSONL into records (raises on unparseable lines —
    the atomic-rotate sink never commits a torn tail, so a parse failure
    means the file is not a telemetry run)."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSONL: {e}") from e
    return records


def validate_run(records: list[dict]) -> list[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    errors = []
    if not records:
        return ["empty run (no records)"]
    head = records[0]
    if head.get("event") != "run_start":
        errors.append("first record is not run_start")
    elif head.get("schema_version") != SCHEMA_VERSION:
        errors.append(
            f"schema_version {head.get('schema_version')!r} != "
            f"{SCHEMA_VERSION} (this reader)"
        )
    for i, r in enumerate(records):
        if "event" not in r or "t" not in r:
            errors.append(f"record {i}: missing 'event'/'t'")
            continue
        if r["event"] == "span":
            missing = [k for k in _SPAN_REQUIRED if k not in r]
            if missing:
                errors.append(f"record {i}: span missing {missing}")
    return errors


def _phase(name: str) -> str:
    return name.split("/", 1)[0]


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total seconds covered by a set of (start, end) intervals."""
    total = 0.0
    end = -float("inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def summarize_run(path: str, records: list[dict] | None = None) -> dict:
    """One run's JSONL → a JSON-plain summary dict. ``records`` skips
    the re-read when the caller already parsed the file (the fleet
    summarizer loads each shard once for the P2P-event join)."""
    if records is None:
        records = load_run(path)
    errors = validate_run(records)
    if errors:
        raise ValueError(f"{path}: invalid telemetry run: {errors}")

    spans = [r for r in records if r["event"] == "span"]
    by_id = {r["span_id"]: r for r in spans}
    run_start = records[0]
    run_end = next(
        (r for r in records if r["event"] == "run_end"), None
    )
    t_last = max(float(r["t"]) for r in records)

    phases: dict[str, dict] = {}
    entry_intervals: dict[str, list[tuple[float, float]]] = {}
    for s in spans:
        ph = _phase(s["name"])
        agg = phases.setdefault(ph, {"wall_s": 0.0, "spans": 0})
        agg["spans"] += 1
        parent = by_id.get(s.get("parent_id"))
        # only phase-entry spans contribute wall (children re-cover the
        # same seconds), and entry intervals are UNIONED so concurrent
        # worker-thread spans of one phase don't double-count either
        if parent is None or _phase(parent["name"]) != ph:
            t0 = float(s["t"])
            entry_intervals.setdefault(ph, []).append(
                (t0, t0 + float(s["dur_s"]))
            )
    for ph, intervals in entry_intervals.items():
        phases[ph]["wall_s"] = _union_seconds(intervals)

    events: dict[str, int] = {}
    for r in records:
        events[r["event"]] = events.get(r["event"], 0) + 1

    metrics = (run_end or {}).get("metrics", {})
    timers = metrics.get("timers", {})
    base_timers = run_start.get("metrics_baseline", {}).get("timers", {})

    def timer_s(name: str) -> float:
        # delta against the run_start baseline: the registry is process-
        # cumulative, and a second run in the same process must not
        # inherit the first run's seconds
        end = float(timers.get(name, {}).get("seconds", 0.0))
        base = float(base_timers.get(name, {}).get("seconds", 0.0))
        return max(end - base, 0.0)

    counters = metrics.get("counters", {})
    base_counters = run_start.get("metrics_baseline", {}).get("counters", {})

    def counter_v(name: str) -> float:
        # same run_start-baseline delta as timer_s: the registry is
        # process-cumulative, this run's share only
        end = float(counters.get(name, {}).get("value", 0.0))
        base = float(base_counters.get(name, {}).get("value", 0.0))
        return max(end - base, 0.0)

    # random-effect bucket-solve lane accounting (re_solve.* counters,
    # game/random_effect): executed = lane-iterations the launches ran,
    # useful = lane-iterations before each lane converged; their gap is
    # the wasted lockstep work the compaction knob exists to remove
    executed = counter_v("re_solve.executed_entity_iterations")
    useful = counter_v("re_solve.useful_entity_iterations")
    re_solve = {
        "launches": counter_v("re_solve.launches"),
        "executed_entity_iterations": executed,
        "useful_entity_iterations": useful,
        "wasted_lane_fraction": (
            1.0 - useful / executed if executed > 0 else None
        ),
    }

    # entity-sharded placement gauges (re_shard.*, parallel/placement +
    # the overlapped-exchange ratio from parallel/multihost): per-shard
    # load (Σ rows), max/mean balance, and the fraction of exchange wall
    # hidden behind other work — the scale-out counterpart of the
    # wasted-lane accounting below
    metrics_gauges = metrics.get("gauges", {})
    re_shard = {
        k[len("re_shard."):]: float(v)
        for k, v in metrics_gauges.items()
        if k.startswith("re_shard.") and isinstance(v, (int, float))
    } or None

    # fixed-effect feature-range sharding gauges (fe_shard.*,
    # ops/streaming under PHOTON_FE_SHARD): range count, this process's
    # range width and local nnz, and the planner's nnz balance ratio —
    # the FEATURE-axis counterpart of the re_shard row-placement block
    fe_shard = {
        k[len("fe_shard."):]: float(v)
        for k, v in metrics_gauges.items()
        if k.startswith("fe_shard.") and isinstance(v, (int, float))
    } or None

    optim = [r for r in records if r["event"] == "optim_result"]
    reasons: dict[str, int] = {}
    for r in optim:
        reasons[str(r.get("reason"))] = reasons.get(str(r.get("reason")), 0) + 1

    # precision-ladder quality parity (BASELINE protocol: speed is never
    # reported without a parity check): a reduced-precision bench run
    # emits a quality_parity event with its AUC/RMSE/loss deltas against
    # the f32 anchor — surfaced here so a dtype sweep reads its quality
    # gate from the same report as its wall numbers
    quality_parity = None
    for r in records:
        if r["event"] == "quality_parity":
            quality_parity = {
                k: v for k, v in r.items() if k not in ("event", "t")
            }

    # analytic device cost (obs/devcost executable_cost records): one
    # roofline row per (capture label, knob tuple) — flops,
    # bytes-accessed, arithmetic intensity, peak memory. Sums are over
    # fresh executables only (the capture layer dedups cache hits).
    # Aggregating across knob tuples would merge precision rungs (a
    # reduced-rung run can capture the same label under both rungs), so
    # a label that appears under several knob tuples gets one row per
    # tuple, suffixed with the knobs that differ.
    by_label_knobs: dict[tuple, dict] = {}
    for r in records:
        if r["event"] != "executable_cost":
            continue
        knobs = r.get("knobs") or {}
        k = (str(r.get("label")), tuple(sorted(knobs.items())))
        agg = by_label_knobs.setdefault(
            k,
            {
                "captures": 0, "flops": 0.0, "bytes_accessed": 0.0,
                "peak_bytes": 0, "peak_is_estimate": False,
                "capture_s": 0.0, "knobs": knobs,
            },
        )
        agg["captures"] += 1
        agg["flops"] += float(r.get("flops") or 0.0)
        agg["bytes_accessed"] += float(r.get("bytes_accessed") or 0.0)
        agg["peak_bytes"] = max(
            agg["peak_bytes"], int(r.get("peak_bytes") or 0)
        )
        agg["peak_is_estimate"] = agg["peak_is_estimate"] or bool(
            r.get("peak_is_estimate")
        )
        agg["capture_s"] += float(r.get("capture_s") or 0.0)
    label_variants: dict[str, list] = {}
    for (lab, _), agg in by_label_knobs.items():
        label_variants.setdefault(lab, []).append(agg)
    run_knobs = run_start.get("knobs", {})
    devcost: dict[str, dict] = {}
    for lab, variants in label_variants.items():
        if len(variants) == 1:
            devcost[lab] = variants[0]
            continue
        # naming must be STABLE for gating: the variant matching the
        # RUN'S OWN knobs keeps the bare label (the name a single-variant
        # baseline run produced), and off-run variants (e.g. the f32
        # quality-parity anchor captured inside a bf16 run) are suffixed
        # by their delta vs the run knobs — so adding an anchor capture
        # never renames the run's native metrics out from under a
        # committed baseline
        all_keys = set().union(*(v["knobs"] for v in variants))
        differing_between = sorted(
            kk for kk in all_keys
            if len({repr(v["knobs"].get(kk)) for v in variants}) > 1
        )
        for v in variants:
            diff_vs_run = sorted(
                kk for kk in v["knobs"]
                if repr(v["knobs"][kk]) != repr(run_knobs.get(kk))
            )
            if not diff_vs_run and lab not in devcost:
                # `lab not in devcost`: two variants can BOTH be
                # consistent with the run knobs (one captured with a
                # partial knob dict) — the second must fall through to a
                # suffixed name instead of overwriting the first
                devcost[lab] = v
                continue
            suffix = ",".join(f"{kk}={v['knobs'][kk]}" for kk in diff_vs_run)
            name = f"{lab}[{suffix}]" if diff_vs_run else lab
            if name in devcost:  # disambiguate fully
                suffix = ",".join(
                    f"{kk}={v['knobs'].get(kk)}" for kk in differing_between
                )
                name = f"{lab}[{suffix}]"
            devcost[name] = v
    for agg in devcost.values():
        b = agg["bytes_accessed"]
        agg["arith_intensity"] = (agg["flops"] / b) if b else None

    # runtime HBM axis: budget source (queried vs fallback) + watermark
    # samples from root-span exits; explicit unavailability on backends
    # without memory stats, so "no pressure" and "no instrument" read
    # differently
    gauges = metrics.get("gauges", {})
    budget_ev = [r for r in records if r["event"] == "hbm_budget"]
    wm = [r for r in records if r["event"] == "hbm_watermark"]
    wm_avail = [r for r in wm if r.get("available")]
    # source: the hbm_budget event when one landed, else the persistent
    # hbm.budget_queried gauge (the FIRST budget query of a run can
    # precede sink activation — run_start's own knob snapshot triggers
    # it — and later calls are memoized, so the gauge is the durable
    # record of which source won)
    if budget_ev:
        budget_source = budget_ev[-1].get("source")
    elif gauges.get("hbm.budget_bytes") is not None:
        budget_source = (
            "device_memory_stats"
            if gauges.get("hbm.budget_queried") else "fallback_default"
        )
    else:
        budget_source = None
    hbm = {
        "budget_bytes": (
            budget_ev[-1].get("budget_bytes") if budget_ev
            else gauges.get("hbm.budget_bytes")
        ),
        "budget_source": budget_source,
        "memory_stats_available": (
            bool(wm_avail) if wm else None  # None = never sampled
        ),
        "watermark_samples": len(wm_avail),
        "peak_bytes_in_use": (
            max(int(r.get("peak_bytes_in_use") or 0) for r in wm_avail)
            if wm_avail else None
        ),
    }

    out = {
        "path": os.path.abspath(path),
        "run_id": run_start.get("run_id"),
        "schema_version": run_start.get("schema_version"),
        "knobs": run_start.get("knobs", {}),
        "wall_s": t_last - float(run_start["t"]),
        "complete": run_end is not None,
        "phases": phases,
        # the kernel build (nvcc) seconds: the port's compile
        "compile_s": timer_s("cuda.build_s"),
        "transfer_s": timer_s("prefetch.device_put_s"),
        "host_pack_s": timer_s("prefetch.host_pack_s"),
        "consumer_wait_s": timer_s("prefetch.consumer_wait_s"),
        "events": events,
        "optim": {
            "solves": len(optim),
            "iterations": sum(int(r.get("iterations", 0)) for r in optim),
            "reasons": reasons,
        },
        "re_solve": re_solve,
        "re_shard": re_shard,
        "fe_shard": fe_shard,
        "quality_parity": quality_parity,
        "devcost": devcost,
        "hbm": hbm,
        "warnings": sum(
            1 for r in records
            if r["event"] == "log" and r.get("level") in ("WARN", "ERROR")
        ),
        "metrics": metrics,
    }
    # overlapped-exchange accounting — only on runs that recorded it, so
    # the summary of a fleet-off run stays key-for-key what it was
    if "re_exchange.exchange_s" in timers or \
            "re_exchange.exchange_s" in base_timers:
        out["exchange_s"] = timer_s("re_exchange.exchange_s")
        out["exchange_wait_s"] = timer_s("re_exchange.wait_s")
    # owned-result combine accounting (re_combine.*, game/random_effect):
    # bytes shipped per process by the cross-process combine — the
    # O(P·E·d)-vs-O(E·d) axis of the PHOTON_RE_COMBINE A/B — plus, on
    # the segments arm, the worker-side exchange wall vs the consumer's
    # blocked wait. Present only on runs that combined.
    if "re_combine.exchanges" in counters or \
            "re_combine.exchanges" in base_counters:
        out["re_combine"] = {
            "exchanges": counter_v("re_combine.exchanges"),
            "bytes_sent": counter_v("re_combine.bytes_sent"),
            "exchange_s": timer_s("re_combine.exchange_s"),
            "wait_s": timer_s("re_combine.wait_s"),
            "mode": run_start.get("knobs", {}).get("re_combine"),
        }
    # per-entity feature projection (re_project.*, game/projector): the
    # mean solved-width ratio and the per-lane bytes the subspace solves
    # shaved off the full-width schedule, plus the ladder narrative
    # (per-class support/hash widths) from the re_project event. Present
    # only on projected runs — an unprojected summary stays key-for-key
    # what it was.
    project_events = [r for r in records if r["event"] == "re_project"]
    if (
        metrics_gauges.get("re_project.mean_ratio") is not None
        or project_events
    ):
        out["re_project"] = {
            "mean_ratio": metrics_gauges.get("re_project.mean_ratio"),
            "dims_saved_bytes": metrics_gauges.get(
                "re_project.dims_saved_bytes"
            ),
            "mode": (
                project_events[-1].get("mode") if project_events else None
            ),
            "classes": (
                project_events[-1].get("classes")
                if project_events else None
            ),
        }
    # telemetry-driven re-planning (re_replan.*, game/streaming): checks
    # per iteration, re-plans fired, entities migrated — plus the event
    # narrative report fleet renders
    replan_events = [
        {
            k: r.get(k)
            for k in ("iteration", "coordinate", "imbalance",
                      "threshold", "migrated", "old_balance",
                      "new_balance")
        }
        for r in records if r["event"] == "re_replan"
    ]
    if (
        "re_replan.checks" in counters
        or "re_replan.checks" in base_counters
        or replan_events
    ):
        out["re_replan"] = {
            "checks": counter_v("re_replan.checks"),
            "replans": counter_v("re_replan.count"),
            "migrations": counter_v("re_replan.migrations"),
            "last_imbalance": metrics_gauges.get(
                "re_replan.last_imbalance"
            ),
            "events": replan_events,
        }
    # online serving (serve.*; ROADMAP queue 1 item 8): the latency section —
    # request/window counts, micro-window wall ("serve.window_s") and fill
    # ("serve.window.occupancy" histogram, mean gauge), the hot working
    # set's byte traffic ("serve.hot.hit_bytes" / "serve.hot.miss_bytes" /
    # "serve.hot.evictions") plus its request-count hit rate, cross-owner
    # forwards ("serve.forwarded"), incremental refreshes
    # ("serve.refresh.count" / "serve.refresh_s") and the loadgen's
    # open-loop percentile gauges. Present only on runs that served — a
    # non-serving summary stays key-for-key what it was.
    if "serve.requests" in counters or "serve.requests" in base_counters:
        out["serve"] = {
            "requests": counter_v("serve.requests"),
            "windows": counter_v("serve.windows"),
            "forwarded": counter_v("serve.forwarded"),
            "window_s": timer_s("serve.window_s"),
            "hot_hit_bytes": counter_v("serve.hot.hit_bytes"),
            "hot_miss_bytes": counter_v("serve.hot.miss_bytes"),
            "hot_evictions": counter_v("serve.hot.evictions"),
            "refreshes": counter_v("serve.refresh.count"),
            "refresh_s": timer_s("serve.refresh_s"),
            "latency_p50_ms": metrics_gauges.get("serve.latency_p50_ms"),
            "latency_p99_ms": metrics_gauges.get("serve.latency_p99_ms"),
            "hot_hit_rate": metrics_gauges.get("serve.hot.hit_rate"),
            "window_occupancy_mean": metrics_gauges.get(
                "serve.window.occupancy_mean"
            ),
        }
        # traffic-driven ownership migration (serve.replan.*): present
        # only when the router re-planned — pre-executor serve summaries
        # stay key-for-key what they were
        if "serve.replan.count" in counters or \
                "serve.replan.count" in base_counters:
            out["serve"]["replans"] = counter_v("serve.replan.count")
            out["serve"]["replan_migrations"] = counter_v(
                "serve.replan.migrations"
            )
    # streaming executor (stream.cache.* / stream.<consumer>.*,
    # ops/stream_executor.py): the multi-tenant arbiter's byte traffic —
    # "stream.cache.hit_bytes" / "stream.cache.miss_bytes" /
    # "stream.cache.shared_hit_bytes" (hits on entries ANOTHER consumer
    # admitted: the cross-stream dedup) / "stream.cache.evictions" — and
    # a per-consumer breakdown parsed from the wildcard counter family
    # ("stream.<name>.items" / ".hit_bytes" / ".miss_bytes" / ".yields",
    # timer "stream.<name>.wait_s", gauge "stream.<name>.charged_bytes").
    # Present only on executor-on runs — every committed executor-off
    # summary stays key-for-key what it was.
    if "stream.cache.hit_bytes" in counters \
            or "stream.cache.hit_bytes" in base_counters \
            or "stream.cache.miss_bytes" in counters \
            or "stream.cache.miss_bytes" in base_counters:
        consumers: dict = {}
        skip = {"passes", "chunks", "streams", "cache"}
        for cname in set(counters) | set(base_counters):
            parts = cname.split(".")
            if len(parts) != 3 or parts[0] != "stream":
                continue
            name = parts[1]
            if name in skip:
                continue
            c = consumers.setdefault(name, {
                "items": 0.0, "hit_bytes": 0.0, "miss_bytes": 0.0,
                "yields": 0.0,
            })
            if parts[2] in c:
                c[parts[2]] = counter_v(cname)
        for tname in set(timers) | set(base_timers):
            parts = tname.split(".")
            if len(parts) == 3 and parts[0] == "stream" \
                    and parts[2] == "wait_s" and parts[1] not in skip:
                consumers.setdefault(parts[1], {})["wait_s"] = timer_s(
                    tname
                )
        for gname, gval in metrics_gauges.items():
            parts = gname.split(".")
            if len(parts) == 3 and parts[0] == "stream" \
                    and parts[2] == "charged_bytes" and parts[1] not in skip:
                consumers.setdefault(parts[1], {})["charged_bytes"] = gval
        se_cache = (run_end or {}).get("stream_cache") or {}
        out["stream"] = {
            "streams": counter_v("stream.streams"),
            "cache_hit_bytes": counter_v("stream.cache.hit_bytes"),
            "cache_shared_hit_bytes": counter_v(
                "stream.cache.shared_hit_bytes"
            ),
            "cache_miss_bytes": counter_v("stream.cache.miss_bytes"),
            "cache_evictions": counter_v("stream.cache.evictions"),
            "cache_entries": se_cache.get("entries"),
            "cache_bytes": se_cache.get("bytes"),
            "charges": se_cache.get("charges"),
            "consumers": consumers,
        }
    if run_start.get("fleet"):
        out["fleet"] = run_start["fleet"]
    return out


# -- rendering --------------------------------------------------------------

_UNRECORDED = "(unrecorded)"


def _fmt_s(v: float) -> str:
    return f"{v:.3f}s"


def _fmt_qty(v: float | None) -> str:
    """Compact engineering format for flops/bytes (roofline cells)."""
    if v is None:
        return "-"
    v = float(v)
    for div, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= div:
            return f"{v / div:.2f}{suffix}"
    return f"{v:.0f}"


def _fmt_quality_parity(qp: dict) -> str:
    # every delta/RMSE metric renders — the gate's whole point is that a
    # bad number is impossible to miss next to the wall numbers
    parts = [f"kernel_dtype={qp.get('kernel_dtype')}"]
    for k in sorted(qp):
        if k.endswith("_delta") or "rmse" in k:
            v = qp[k]
            parts.append(f"{k}={v:+.6f}" if isinstance(v, float) else f"{k}={v}")
    return ", ".join(parts)


def format_summary(s: dict) -> str:
    lines = [
        f"run {s['run_id']}  (schema v{s['schema_version']}, "
        f"{'complete' if s['complete'] else 'NO run_end — truncated?'})",
        f"  wall {_fmt_s(s['wall_s'])}   compile {_fmt_s(s['compile_s'])}   "
        f"transfer {_fmt_s(s['transfer_s'])}   "
        f"host-pack {_fmt_s(s['host_pack_s'])}   "
        f"consumer-wait {_fmt_s(s['consumer_wait_s'])}",
        "",
        f"  {'phase':<16} {'wall':>10} {'spans':>7}",
    ]
    for ph, agg in sorted(
        s["phases"].items(), key=lambda kv: -kv[1]["wall_s"]
    ):
        lines.append(
            f"  {ph:<16} {_fmt_s(agg['wall_s']):>10} {agg['spans']:>7}"
        )
    o = s["optim"]
    if o["solves"]:
        reasons = ", ".join(f"{k}×{v}" for k, v in sorted(o["reasons"].items()))
        lines.append(
            f"  optimizer: {o['solves']} solves, {o['iterations']} "
            f"iterations ({reasons})"
        )
    rs = s.get("re_solve") or {}
    if rs.get("executed_entity_iterations"):
        lines.append(
            f"  re-solve: {int(rs['launches'])} launches, "
            f"{int(rs['executed_entity_iterations'])} executed entity-iters "
            f"({int(rs['useful_entity_iterations'])} useful), "
            f"wasted-lane {rs['wasted_lane_fraction']:.1%}"
        )
    rsh = s.get("re_shard") or {}
    if rsh.get("shards"):
        overlap = rsh.get("exchange_overlap_ratio")
        atoms = rsh.get("atoms")
        split_classes = int(rsh.get("split_classes") or 0)
        lines.append(
            f"  re-shard: {int(rsh['shards'])} shards, rows "
            f"{rsh.get('rows', 0):.0f} "
            f"(max {rsh.get('rows_max', 0):.0f} / mean "
            f"{rsh.get('rows_mean', 0):.1f}), "
            f"balance {rsh.get('balance', 1.0):.3f}x"
            + (
                # placement granularity (PHOTON_RE_SPLIT): how many
                # independently-placeable atoms the balance was achieved
                # over, and how many capacity classes the rule split
                f", atoms {int(atoms)}"
                + (f" ({split_classes} split)" if split_classes else "")
                if atoms is not None else ""
            )
            + (
                f", exchange-overlap {overlap:.1%}"
                if overlap is not None else ""
            )
        )
        # second placement level (PHOTON_RE_DEVICE_SPLIT): this
        # process's owned atoms spread over its LOCAL devices
        dbal = rsh.get("device_balance")
        if dbal is not None:
            lines.append(
                f"  re-shard devices: {int(rsh.get('devices') or 0)} local, "
                f"device balance {dbal:.3f}x"
            )
    fsh = s.get("fe_shard") or {}
    if fsh.get("ranges"):
        lines.append(
            f"  fe-shard: {int(fsh['ranges'])} ranges, width "
            f"{fsh.get('width', 0):.0f}, local nnz "
            f"{fsh.get('nnz_local', 0):.0f}, "
            f"nnz balance {fsh.get('nnz_balance', 1.0):.3f}x"
        )
    rc = s.get("re_combine") or {}
    if rc.get("exchanges"):
        seg = (
            f"  re-combine: {int(rc['exchanges'])} combines, "
            f"{_fmt_qty(rc['bytes_sent'])}B sent"
            + (f" (mode {rc['mode']})" if rc.get("mode") else "")
        )
        if rc.get("exchange_s"):
            seg += (
                f", exch {_fmt_s(rc['exchange_s'])} / wait "
                f"{_fmt_s(rc['wait_s'])}"
            )
        lines.append(seg)
    prj = s.get("re_project") or {}
    if prj.get("mean_ratio") is not None or prj.get("classes"):
        ratio = prj.get("mean_ratio")
        saved = prj.get("dims_saved_bytes")
        lines.append(
            "  re-project:"
            + (f" mode {prj['mode']}," if prj.get("mode") else "")
            + (
                f" mean width ratio {ratio:.3f}"
                if isinstance(ratio, (int, float)) else ""
            )
            + (
                f", {_fmt_qty(saved)}B/lane-row saved"
                if isinstance(saved, (int, float)) else ""
            )
        )
        for c in prj.get("classes") or []:
            lines.append(
                f"    class C={int(c.get('capacity', 0))}: "
                f"support {int(c.get('support_dim', 0))} -> "
                f"dim {int(c.get('dim', 0))}"
                + (" (hashed)" if c.get("hashed") else "")
            )
    rp = s.get("re_replan") or {}
    if rp.get("checks") or rp.get("migrations"):
        lines.append(
            f"  re-plan: {int(rp.get('checks') or 0)} checks, "
            f"{int(rp.get('replans') or 0)} re-plans, "
            f"{int(rp.get('migrations') or 0)} entities migrated"
            + (
                f" (last imbalance {rp['last_imbalance']:.2f}x)"
                if isinstance(rp.get("last_imbalance"), (int, float))
                else ""
            )
        )
    sv = s.get("serve") or {}
    if sv.get("requests"):
        p50, p99 = sv.get("latency_p50_ms"), sv.get("latency_p99_ms")
        lines.append(
            f"  serve: {int(sv['requests'])} requests in "
            f"{int(sv['windows'])} windows"
            + (
                f", p50 {p50:.2f} ms / p99 {p99:.2f} ms"
                if isinstance(p50, (int, float))
                and isinstance(p99, (int, float)) else ""
            )
            + (
                f", occupancy {sv['window_occupancy_mean']:.2f}"
                if isinstance(sv.get("window_occupancy_mean"),
                              (int, float)) else ""
            )
        )
        lines.append(
            f"    hot set: hit rate "
            + (
                f"{sv['hot_hit_rate']:.3f}"
                if isinstance(sv.get("hot_hit_rate"), (int, float))
                else _UNRECORDED
            )
            + f", {_fmt_qty(sv.get('hot_hit_bytes') or 0.0)}B hit / "
            f"{_fmt_qty(sv.get('hot_miss_bytes') or 0.0)}B miss, "
            f"{int(sv.get('hot_evictions') or 0)} evictions"
        )
        if sv.get("forwarded") or sv.get("refreshes"):
            lines.append(
                f"    {int(sv.get('forwarded') or 0)} cross-owner "
                f"forwards, {int(sv.get('refreshes') or 0)} refreshes"
                + (
                    f" ({_fmt_s(sv['refresh_s'])})"
                    if sv.get("refresh_s") else ""
                )
            )
        if sv.get("replans"):
            lines.append(
                f"    traffic re-plan: {int(sv['replans'])} re-plans, "
                f"{int(sv.get('replan_migrations') or 0)} entities "
                f"migrated"
            )
    stm = s.get("stream") or {}
    if stm.get("streams") or stm.get("consumers"):
        lines.append(
            f"  stream executor: {int(stm.get('streams') or 0)} streams, "
            f"{_fmt_qty(stm.get('cache_hit_bytes') or 0.0)}B hit "
            f"({_fmt_qty(stm.get('cache_shared_hit_bytes') or 0.0)}B "
            f"shared) / {_fmt_qty(stm.get('cache_miss_bytes') or 0.0)}B "
            f"miss, {int(stm.get('cache_evictions') or 0)} evictions"
        )
        for name, c in sorted((stm.get("consumers") or {}).items()):
            lines.append(
                f"    {name}: {int(c.get('items') or 0)} items, "
                f"{_fmt_qty(c.get('hit_bytes') or 0.0)}B hit / "
                f"{_fmt_qty(c.get('miss_bytes') or 0.0)}B miss, "
                f"wait {_fmt_s(c.get('wait_s') or 0.0)}, charged "
                f"{_fmt_qty(c.get('charged_bytes') or 0.0)}B, "
                f"{int(c.get('yields') or 0)} yields"
            )
    if s.get("quality_parity"):
        lines.append(
            f"  quality-parity: {_fmt_quality_parity(s['quality_parity'])}"
        )
    dc = s.get("devcost") or {}
    if dc:
        est = any(a.get("peak_is_estimate") for a in dc.values())
        lines.append("")
        # the reference's heading, kept so both packages render a run
        # the same; the port's numbers are its kernels' analytic counts
        lines.append(
            "  analytic device cost (XLA estimates"
            + ("; peak = arg+out+temp estimate" if est else "")
            + "):"
        )
        lines.append(
            f"  {'label':<34} {'flops':>9} {'bytes':>9} {'fl/B':>6} "
            f"{'peak':>9} {'caps':>5}"
        )
        for lab, a in sorted(
            dc.items(), key=lambda kv: -kv[1]["bytes_accessed"]
        ):
            ai = a.get("arith_intensity")
            lines.append(
                f"  {lab:<34} {_fmt_qty(a['flops']):>9} "
                f"{_fmt_qty(a['bytes_accessed']):>9} "
                f"{'-' if ai is None else f'{ai:.1f}':>6} "
                f"{_fmt_qty(a['peak_bytes']):>9} {a['captures']:>5}"
            )
        kd = next(
            (a["knobs"].get("kernel_dtype") for a in dc.values()
             if a.get("knobs", {}).get("kernel_dtype")), None,
        )
        if kd:
            lines.append(f"  (captured under kernel_dtype={kd})")
    hbm = s.get("hbm") or {}
    if hbm.get("budget_bytes") is not None or hbm.get(
        "memory_stats_available"
    ) is not None:
        avail = hbm.get("memory_stats_available")
        wm_txt = (
            f"peak in-use {_fmt_qty(hbm['peak_bytes_in_use'])}B over "
            f"{hbm['watermark_samples']} samples"
            if avail
            else "memory_stats unavailable on this backend"
            if avail is False
            else "no watermark samples"
        )
        src = hbm.get("budget_source")
        lines.append(
            f"  hbm: budget {_fmt_qty(hbm.get('budget_bytes'))}B"
            + (f" ({src})" if src else "")
            + f"; {wm_txt}"
        )
    if s["warnings"]:
        lines.append(f"  warnings: {s['warnings']}")
    if s["knobs"]:
        lines.append(f"  knobs: {json.dumps(s['knobs'], sort_keys=True)}")
    return "\n".join(lines)


def diff_summaries(a: dict, b: dict) -> str:
    """Two runs side by side: per-phase wall, compile/transfer split, knob
    deltas — the sweep-readout format."""
    lines = [
        f"A: {a['run_id']}  ({os.path.basename(a['path'])})",
        f"B: {b['run_id']}  ({os.path.basename(b['path'])})",
        "",
        f"  {'':<16} {'A':>10} {'B':>10} {'B/A':>7}",
    ]

    def row(label: str, va: float, vb: float):
        ratio = (vb / va) if va > 0 else float("inf") if vb > 0 else 1.0
        lines.append(
            f"  {label:<16} {_fmt_s(va):>10} {_fmt_s(vb):>10} {ratio:>7.2f}"
        )

    row("wall", a["wall_s"], b["wall_s"])
    for ph in sorted(set(a["phases"]) | set(b["phases"])):
        row(
            ph,
            a["phases"].get(ph, {}).get("wall_s", 0.0),
            b["phases"].get(ph, {}).get("wall_s", 0.0),
        )
    row("compile", a["compile_s"], b["compile_s"])
    row("transfer", a["transfer_s"], b["transfer_s"])
    row("host-pack", a["host_pack_s"], b["host_pack_s"])
    row("consumer-wait", a["consumer_wait_s"], b["consumer_wait_s"])
    ra, rb = a.get("re_solve") or {}, b.get("re_solve") or {}
    if ra.get("executed_entity_iterations") or rb.get("executed_entity_iterations"):
        # the wasted-lane column: the knob-sweep readout for
        # PHOTON_RE_COMPACT_EVERY / PHOTON_RE_FUSE_BUCKETS
        def pct(v):
            return "-" if v is None else f"{v:.1%}"

        lines.append(
            f"  {'wasted-lane':<16} "
            f"{pct(ra.get('wasted_lane_fraction')):>10} "
            f"{pct(rb.get('wasted_lane_fraction')):>10}"
        )
        lines.append(
            f"  {'exec-entity-it':<16} "
            f"{int(ra.get('executed_entity_iterations') or 0):>10} "
            f"{int(rb.get('executed_entity_iterations') or 0):>10}"
        )
    sha, shb = a.get("re_shard") or {}, b.get("re_shard") or {}
    if sha.get("shards") or shb.get("shards"):
        # the per-shard load-balance line, next to the wasted-lane
        # column: the placement-sweep readout for PHOTON_RE_SHARD
        def bal(v):
            return "-" if v is None else f"{v:.3f}x"

        def pct2(v):
            return "-" if v is None else f"{v:.1%}"

        lines.append(
            f"  {'shard-balance':<16} {bal(sha.get('balance')):>10} "
            f"{bal(shb.get('balance')):>10}"
        )
        lines.append(
            f"  {'shard-rows-max':<16} "
            f"{sha.get('rows_max', 0):>10.0f} "
            f"{shb.get('rows_max', 0):>10.0f}"
        )
        lines.append(
            f"  {'exch-overlap':<16} "
            f"{pct2(sha.get('exchange_overlap_ratio')):>10} "
            f"{pct2(shb.get('exchange_overlap_ratio')):>10}"
        )
    da, db = a.get("devcost") or {}, b.get("devcost") or {}
    if da or db:
        # the knob-keyed byte-delta readout: the dtype-ladder /
        # groups-per-run sweeps read their analytic traffic change here
        lines.append("  analytic bytes-accessed (per executable label):")
        for lab in sorted(set(da) | set(db)):
            va = (da.get(lab) or {}).get("bytes_accessed", 0.0)
            vb = (db.get(lab) or {}).get("bytes_accessed", 0.0)
            ratio = (
                f"{vb / va:.2f}" if va else ("inf" if vb else "1.00")
            )
            lines.append(
                f"    {lab:<32} {_fmt_qty(va):>9} {_fmt_qty(vb):>9} "
                f"{ratio:>7}"
            )
    qa, qb = a.get("quality_parity"), b.get("quality_parity")
    if qa or qb:
        lines.append("  quality-parity:")
        lines.append(
            f"    A: {_fmt_quality_parity(qa) if qa else _UNRECORDED}"
        )
        lines.append(
            f"    B: {_fmt_quality_parity(qb) if qb else _UNRECORDED}"
        )
    ka, kb = a.get("knobs", {}), b.get("knobs", {})
    # a knob only one run recorded (an older-schema run, or a pre-knob
    # baseline) renders as "(unrecorded)" instead of being dropped — an
    # asymmetric PHOTON_KERNEL_DTYPE is a real config delta, and the
    # `(k in ka) != (k in kb)` term keeps it even when .get() values
    # would coincide (e.g. a knob legitimately recorded as None)
    knob_keys = set(ka) | set(kb)
    knob_diffs = {
        k: (
            ka[k] if k in ka else _UNRECORDED,
            kb[k] if k in kb else _UNRECORDED,
        )
        for k in sorted(knob_keys)
        if (k in ka) != (k in kb) or ka.get(k) != kb.get(k)
    }
    if knob_diffs:
        lines.append("  knob deltas:")
        for k, (va, vb) in knob_diffs.items():
            lines.append(f"    {k}: {va!r} -> {vb!r}")
    return "\n".join(lines)


def latest_run(directory: str) -> str | None:
    """Newest CANONICAL ``run-*.jsonl`` in a telemetry directory (mtime
    order). ``.p<k>`` fleet shards are excluded — the newest run of a
    fleet directory is its process-0 file, exactly what every
    single-process consumer expects."""
    runs = [
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith("run-") and f.endswith(".jsonl")
        and not _SHARD_RE.search(f)
    ]
    return max(runs, key=os.path.getmtime) if runs else None


def fleet_run_paths(path: str, run_id: str | None = None) -> list[str]:
    """All files of one fleet run, canonical first: given a telemetry
    directory (newest canonical run, or ``run_id``), a canonical run
    file, or any one shard, return ``[run-<id>.jsonl,
    run-<id>.p1.jsonl, …]`` in ascending process order. A run with no
    shards returns just its canonical file, so every fleet entry point
    degrades to the single-process view."""
    if os.path.isdir(path):
        if run_id is not None:
            canonical = os.path.join(path, f"run-{run_id}.jsonl")
            if not os.path.exists(canonical):
                raise ValueError(
                    f"no run-{run_id}.jsonl in {path}"
                )
        else:
            canonical = latest_run(path)
            if canonical is None:
                raise ValueError(f"no run-*.jsonl files in {path}")
    else:
        canonical = path
        m = _SHARD_RE.search(canonical)
        if m:  # a shard was named: walk back to its canonical file
            canonical = canonical[: m.start()] + ".jsonl"
        if not canonical.endswith(".jsonl"):
            raise ValueError(
                f"not a telemetry run file (want *.jsonl): {canonical}"
            )
        if not os.path.exists(canonical):
            raise ValueError(f"canonical run file missing: {canonical}")
    base = os.path.basename(canonical)
    directory = os.path.dirname(canonical) or "."
    stem = base[: -len(".jsonl")]
    shard_re = re.compile(re.escape(stem) + r"\.p(\d+)\.jsonl$")
    shards: dict[int, str] = {}
    for f in os.listdir(directory):
        m = shard_re.fullmatch(f)
        if m:
            shards[int(m.group(1))] = os.path.join(directory, f)
    return [canonical] + [shards[k] for k in sorted(shards)]


# -- fleet view --------------------------------------------------------------
#
# ``photon-ml-tpu-torch report fleet RUNDIR`` joins one run's canonical file
# and its per-process shards into the cross-process readout the on-chip
# multichip sweeps gate on: a per-process phase-wall table, a straggler
# summary (max/median/imbalance per phase, slowest process named), a
# per-link P2P table built by joining the correlated ``p2p_send`` /
# ``p2p_recv`` events the framed exchange emits on both ends of every
# link (one-sided wait = recv-start − send-start; same-host clocks on
# the loopback harness, NTP-disciplined hosts on a pod — cross-host
# skew shows up as negative waits, which clip to zero), and an
# unmatched-event count as a telemetry-health signal (a clean run joins
# every pair; unmatched events mean a torn mesh, a lost shard file, or
# a truncated run).


def _p2p_link_table(records_by_process: dict[int, list[dict]]) -> dict:
    """Join correlated send/recv events across all shards of one run."""
    sends: dict[str, dict] = {}
    recvs: dict[str, dict] = {}
    duplicates = 0
    heartbeats = 0
    for recs in records_by_process.values():
        for r in recs:
            ev = r.get("event")
            if ev == "p2p_heartbeat":
                heartbeats += 1
                continue
            if ev not in ("p2p_send", "p2p_recv"):
                continue
            corr = str(r.get("corr"))
            side = sends if ev == "p2p_send" else recvs
            if corr in side:
                duplicates += 1
            side[corr] = r
    links: dict[str, dict] = {}

    def link_agg(corr: str) -> dict | None:
        # corr = "p2p:<src>><dst>#<seq>"
        m = re.fullmatch(r"p2p:(\d+)>(\d+)#\d+", corr)
        if m is None:
            return None
        return links.setdefault(
            f"{m.group(1)}->{m.group(2)}",
            {
                "transfers": 0, "bytes": 0, "rows": 0,
                "send_s": 0.0, "recv_s": 0.0,
                "one_sided_wait_s": 0.0, "matched": 0,
                "tags": [],
            },
        )

    matched = 0
    for corr, s in sends.items():
        agg = link_agg(corr)
        if agg is None:
            continue
        agg["transfers"] += 1
        agg["bytes"] += int(s.get("bytes") or 0)
        agg["rows"] += int(s.get("rows") or 0)
        agg["send_s"] += float(s.get("dur_s") or 0.0)
        t = str(s.get("tag") or "")
        if t and t not in agg["tags"]:
            agg["tags"].append(t)
        r = recvs.get(corr)
        if r is None:
            continue
        matched += 1
        agg["matched"] += 1
        agg["recv_s"] += float(r.get("dur_s") or 0.0)
        agg["one_sided_wait_s"] += max(
            float(r.get("t_start") or 0.0) - float(s.get("t_start") or 0.0),
            0.0,
        )
    # recv-only correlations still surface on their link rows
    for corr, r in recvs.items():
        if corr in sends:
            continue
        agg = link_agg(corr)
        if agg is None:
            continue
        agg["transfers"] += 1
        agg["recv_s"] += float(r.get("dur_s") or 0.0)
    unmatched = (len(sends) - matched) + (len(recvs) - matched)
    for agg in links.values():
        agg["tags"] = sorted(agg["tags"])
    return {
        "links": {k: links[k] for k in sorted(links)},
        "sends": len(sends),
        "recvs": len(recvs),
        "matched": matched,
        "unmatched": unmatched,
        "duplicate_correlations": duplicates,
        "heartbeats": heartbeats,
    }


def summarize_fleet(paths: list[str]) -> dict:
    """All shards of one run → the merged fleet view (JSON-plain)."""
    if not paths:
        raise ValueError("no run files to summarize")
    processes: dict[str, dict] = {}
    records_by_process: dict[int, list[dict]] = {}
    expected = None
    for p in paths:
        records = load_run(p)
        errors = validate_run(records)
        if errors:
            raise ValueError(f"{p}: invalid telemetry run: {errors}")
        pidx = int(records[0].get("process_index", 0))
        if pidx in records_by_process:
            raise ValueError(
                f"{p}: duplicate process index {pidx} in fleet run"
            )
        records_by_process[pidx] = records
        s = summarize_run(p, records=records)
        s["process_index"] = pidx
        processes[str(pidx)] = s
        fleet_info = records[0].get("fleet") or {}
        if fleet_info.get("process_count"):
            expected = int(fleet_info["process_count"])
    pidxs = sorted(records_by_process)
    run_ids = {s["run_id"] for s in processes.values()}
    if len(run_ids) > 1:
        raise ValueError(f"shards disagree on run_id: {sorted(run_ids)}")

    # per-process phase walls + straggler summary. Imbalance is
    # max/median over ALL processes (absent phases count 0.0): a phase
    # only one process runs — ingest on the data-holding host, say — is
    # by definition maximally imbalanced, which is exactly what a
    # straggler table must say.
    from statistics import median

    phase_names = sorted(
        {ph for s in processes.values() for ph in s["phases"]}
    )
    phases: dict[str, dict] = {}
    for ph in phase_names:
        walls = {
            k: float(s["phases"].get(ph, {}).get("wall_s", 0.0))
            for k, s in processes.items()
        }
        mx = max(walls.values())
        med = median(list(walls.values()))
        slowest = max(walls, key=lambda k: walls[k])
        phases[ph] = {
            "per_process": walls,
            "max_s": mx,
            "median_s": med,
            "imbalance": (mx / med) if med > 0 else None,
            "slowest": int(slowest),
        }
    walls_total = {
        k: float(s["wall_s"]) for k, s in processes.items()
    }
    slowest_proc = max(walls_total, key=lambda k: walls_total[k]) \
        if walls_total else "0"

    overlap = {
        k: (s.get("re_shard") or {}).get("exchange_overlap_ratio")
        for k, s in processes.items()
        if (s.get("re_shard") or {}).get("exchange_overlap_ratio")
        is not None
    }
    # retry/recovery health (the PR-11 fault-tolerance tier): per-link
    # retries and corruption detections are transient absorption (the
    # run still completed); giveups, peer losses and recoveries mark a
    # degraded topology the reader must know about before trusting any
    # imbalance number in this table.
    recovery: dict = {
        "p2p_retries": 0, "p2p_giveups": 0, "drain_errors": 0,
        "faults_injected": 0, "peer_lost": [], "recoveries": [],
        "roll_calls": [], "degraded_descents": [], "rejoins": [],
    }
    replans: list[dict] = []
    retry_by_error: dict[str, int] = {}
    for pidx, recs in records_by_process.items():
        for r in recs:
            ev = r.get("event")
            if ev == "re_replan":
                # ONE fleet decision: every process emits the identical
                # event (the re-plan is computed from allgathered walls),
                # so dedup by (iteration, coordinate) and collect the
                # emitting processes — P copies rendered as P distinct
                # re-plans would read as P·migrated entities moved
                key = (r.get("iteration"), r.get("coordinate"))
                entry = next(
                    (
                        e for e in replans
                        if (e["iteration"], e["coordinate"]) == key
                    ),
                    None,
                )
                if entry is None:
                    replans.append(
                        {
                            "processes": [pidx],
                            "iteration": r.get("iteration"),
                            "coordinate": r.get("coordinate"),
                            "imbalance": r.get("imbalance"),
                            "migrated": r.get("migrated"),
                        }
                    )
                else:
                    entry["processes"].append(pidx)
            elif ev == "p2p_retry":
                recovery["p2p_retries"] += 1
                err = str(r.get("error") or "?")
                retry_by_error[err] = retry_by_error.get(err, 0) + 1
            elif ev == "p2p_giveup":
                recovery["p2p_giveups"] += 1
            elif ev == "exchange_drain_error":
                recovery["drain_errors"] += 1
            elif ev == "fault_injected":
                recovery["faults_injected"] += 1
            elif ev == "peer_lost":
                recovery["peer_lost"].append(
                    {"process": pidx, "peer": r.get("peer")}
                )
            elif ev == "recovery":
                recovery["recoveries"].append(
                    {
                        "process": pidx,
                        "survivors": r.get("survivors"),
                        "lost": r.get("lost"),
                    }
                )
            elif ev == "roll_call":
                recovery["roll_calls"].append(
                    {
                        "process": pidx,
                        "survivors": r.get("survivors"),
                        "lost": r.get("lost"),
                    }
                )
            elif ev == "degraded_descent":
                # the in-memory descent degraded IN PLACE (no restart,
                # no checkpoint re-entry): every survivor emits one
                recovery["degraded_descents"].append(
                    {
                        "process": pidx,
                        "iteration": r.get("iteration"),
                        "survivors": r.get("survivors"),
                        "lost": r.get("lost"),
                    }
                )
            elif ev == "rejoin":
                recovery["rejoins"].append(
                    {
                        "process": pidx,
                        "role": r.get("role"),
                        "rejoined": r.get("rejoined"),
                        "group": r.get("group"),
                        "migrated": r.get("migrated"),
                    }
                )
    recovery["retry_errors"] = dict(sorted(retry_by_error.items()))
    exchange = {
        k: {
            "exchange_s": s["exchange_s"],
            "wait_s": s["exchange_wait_s"],
        }
        for k, s in processes.items()
        if "exchange_s" in s
    }
    # owned-result combine traffic per process + fleet total (the
    # PHOTON_RE_COMBINE A/B axis at fleet granularity)
    combine_pp = {
        k: (s.get("re_combine") or {})
        for k, s in processes.items()
        if s.get("re_combine")
    }
    combine = None
    if combine_pp:
        combine = {
            "bytes_sent_total": float(
                sum(c.get("bytes_sent") or 0 for c in combine_pp.values())
            ),
            "per_process": {
                k: float(c.get("bytes_sent") or 0)
                for k, c in combine_pp.items()
            },
            "mode": next(
                (c.get("mode") for c in combine_pp.values()
                 if c.get("mode")), None,
            ),
        }
    # per-entity projection at fleet granularity: the ladder is
    # replicated (deterministic arithmetic on allreduced activity), so
    # any process's section speaks for the fleet; per-process ratios
    # are surfaced so a disagreeing shard is visible
    project_pp = {
        k: (s.get("re_project") or {})
        for k, s in processes.items()
        if s.get("re_project")
    }
    project = None
    if project_pp:
        first = next(iter(project_pp.values()))
        project = {
            "mode": first.get("mode"),
            "classes": first.get("classes"),
            "per_process_mean_ratio": {
                k: c.get("mean_ratio") for k, c in project_pp.items()
            },
            "mean_ratio": max(
                (
                    float(c["mean_ratio"]) for c in project_pp.values()
                    if isinstance(c.get("mean_ratio"), (int, float))
                ),
                default=None,
            ),
        }
    # online serving at fleet granularity: request/forward totals over
    # the processes that served, the WORST per-process tail (an SLO is a
    # max, not a mean) and the traffic-weighted hot-set hit rate
    serve_pp = {
        k: (s.get("serve") or {})
        for k, s in processes.items()
        if s.get("serve")
    }
    serve = None
    if serve_pp:
        reqs = {
            k: float(c.get("requests") or 0) for k, c in serve_pp.items()
        }
        total_req = sum(reqs.values())
        p99s = [
            float(c["latency_p99_ms"]) for c in serve_pp.values()
            if isinstance(c.get("latency_p99_ms"), (int, float))
        ]
        p50s = [
            float(c["latency_p50_ms"]) for c in serve_pp.values()
            if isinstance(c.get("latency_p50_ms"), (int, float))
        ]
        rates = [
            (reqs[k], float(c["hot_hit_rate"]))
            for k, c in serve_pp.items()
            if isinstance(c.get("hot_hit_rate"), (int, float))
        ]
        serve = {
            "requests_total": total_req,
            "forwarded_total": float(
                sum(c.get("forwarded") or 0 for c in serve_pp.values())
            ),
            "refreshes_total": float(
                sum(c.get("refreshes") or 0 for c in serve_pp.values())
            ),
            "latency_p50_ms_max": max(p50s) if p50s else None,
            "latency_p99_ms_max": max(p99s) if p99s else None,
            "hot_hit_rate": (
                sum(n * r for n, r in rates) / sum(n for n, r in rates)
                if rates and sum(n for n, r in rates) else None
            ),
            "per_process": serve_pp,
        }
    # streaming executor at fleet granularity: arbiter byte totals over
    # the processes that streamed through it (dedup is per-process — the
    # arbiter is process-wide — so totals just sum)
    stream_pp = {
        k: (s.get("stream") or {})
        for k, s in processes.items()
        if s.get("stream")
    }
    stream = None
    if stream_pp:
        stream = {
            "cache_hit_bytes_total": float(sum(
                c.get("cache_hit_bytes") or 0 for c in stream_pp.values()
            )),
            "cache_shared_hit_bytes_total": float(sum(
                c.get("cache_shared_hit_bytes") or 0
                for c in stream_pp.values()
            )),
            "cache_miss_bytes_total": float(sum(
                c.get("cache_miss_bytes") or 0 for c in stream_pp.values()
            )),
            "per_process": stream_pp,
        }
    head = processes[str(pidxs[0])]
    return {
        "run_id": head["run_id"],
        "schema_version": head["schema_version"],
        "knobs": head["knobs"],
        "paths": [os.path.abspath(p) for p in paths],
        "process_count": len(pidxs),
        "expected_process_count": expected,
        "missing_shards": (
            max(expected - len(pidxs), 0) if expected else 0
        ),
        "complete": all(s["complete"] for s in processes.values()),
        "wall_s": max(walls_total.values()) if walls_total else 0.0,
        "phases": phases,
        "straggler": {
            "slowest_process": int(slowest_proc),
            "per_process_wall_s": walls_total,
            "max_imbalance": max(
                (
                    agg["imbalance"]
                    for agg in phases.values()
                    if agg["imbalance"] is not None
                ),
                default=None,
            ),
        },
        "p2p": _p2p_link_table(records_by_process),
        "recovery": recovery,
        "overlap": overlap,
        "exchange": exchange,
        "re_combine": combine,
        "re_project": project,
        "serve": serve,
        "stream": stream,
        "replans": replans,
        "processes": processes,
    }


def _re_shard_fleet_max(fs: dict, name: str) -> float | None:
    """The fleet MAX of one per-process ``re_shard`` gauge — the
    readouts are identical on every process (deterministic planner on
    replicated inputs), so a disagreeing shard (itself a bug) can only
    look worse. ONE rule shared by the fleet render and the fleet
    gate, so the two can never diverge."""
    vals = [
        (s.get("re_shard") or {}).get(name)
        for s in (fs.get("processes") or {}).values()
    ]
    vals = [float(v) for v in vals if isinstance(v, (int, float))]
    return max(vals) if vals else None


def format_fleet(fs: dict) -> str:
    """The fleet-run tables (the human half of ``report fleet``)."""
    pidxs = sorted(int(k) for k in fs["processes"])
    cols = [str(k) for k in pidxs]
    expected = fs.get("expected_process_count")
    head = (
        f"fleet run {fs['run_id']}  (schema v{fs['schema_version']}, "
        f"{fs['process_count']} process"
        f"{'es' if fs['process_count'] != 1 else ''}"
    )
    if fs.get("missing_shards"):
        head += f", {fs['missing_shards']} of {expected} shards MISSING"
    head += ", complete)" if fs["complete"] else ", TRUNCATED?)"
    lines = [head, f"  fleet wall {_fmt_s(fs['wall_s'])}", ""]

    # per-process phase-wall table + straggler columns
    hdr = f"  {'phase':<16}" + "".join(f" {'p' + c:>9}" for c in cols)
    lines.append(hdr + f" {'max':>9} {'imbal':>6}  slowest")
    for ph, agg in sorted(
        fs["phases"].items(), key=lambda kv: -kv[1]["max_s"]
    ):
        row = f"  {ph:<16}" + "".join(
            f" {_fmt_s(agg['per_process'].get(c, 0.0)):>9}" for c in cols
        )
        imb = agg["imbalance"]
        row += (
            f" {_fmt_s(agg['max_s']):>9} "
            f"{'-' if imb is None else f'{imb:.2f}x':>6}  "
            f"p{agg['slowest']}"
        )
        lines.append(row)
    st = fs["straggler"]
    imb = st.get("max_imbalance")
    lines.append(
        f"  straggler: slowest process p{st['slowest_process']} "
        f"(wall {_fmt_s(st['per_process_wall_s'][str(st['slowest_process'])])})"
        + (
            f", worst phase imbalance {imb:.2f}x"
            if imb is not None else ""
        )
    )
    # placement balance + granularity (the fleet MAX of each per-process
    # gauge — same rule the fleet gate applies, one shared helper)
    bal = _re_shard_fleet_max(fs, "balance")
    if bal is not None:
        rows_max = _re_shard_fleet_max(fs, "rows_max")
        fatoms = _re_shard_fleet_max(fs, "atoms")
        fsplit = int(_re_shard_fleet_max(fs, "split_classes") or 0)
        lines.append(
            f"  re-shard: balance {bal:.3f}x"
            + (f", rows max {rows_max:.0f}" if rows_max is not None else "")
            + (
                f", atoms {int(fatoms)}"
                + (f" ({fsplit} split)" if fsplit else "")
                if fatoms is not None else ""
            )
        )
    # second placement level: per-device rows. Unlike the process-level
    # gauges (identical everywhere — deterministic planner on replicated
    # inputs), device loads are PROCESS-LOCAL: each process plans its
    # OWN owned atoms over its OWN local devices. So the table is
    # device x process, same column order as the phase table above.
    dbal = _re_shard_fleet_max(fs, "device_balance")
    if dbal is not None:
        ndev = int(_re_shard_fleet_max(fs, "devices") or 0)
        lines.append(
            f"  re-shard devices: {ndev}/process, "
            f"device balance {dbal:.3f}x (fleet max)"
        )
        for d in range(ndev):
            vals = []
            for c in cols:
                v = (fs["processes"][c].get("re_shard") or {}).get(
                    f"device_rows.{d}"
                )
                vals.append("-" if v is None else f"{v:.0f}")
            lines.append(
                f"  {'device ' + str(d):<16}"
                + "".join(f" {v:>9}" for v in vals)
            )

    if fs.get("overlap") or fs.get("exchange"):
        parts = []
        for c in cols:
            o = fs["overlap"].get(c)
            e = fs["exchange"].get(c) or {}
            seg = f"p{c}"
            if o is not None:
                seg += f" {o:.1%}"
            if e:
                seg += (
                    f" (exch {_fmt_s(e['exchange_s'])}, "
                    f"wait {_fmt_s(e['wait_s'])})"
                )
            parts.append(seg)
        lines.append("  exchange-overlap: " + "  ".join(parts))

    p2p = fs.get("p2p") or {}
    if p2p.get("links"):
        lines.append("")
        lines.append(
            f"  {'link':<8} {'xfers':>6} {'bytes':>9} {'rows':>8} "
            f"{'send':>9} {'wait(1-sided)':>14}  tags"
        )
        for link, a in p2p["links"].items():
            lines.append(
                f"  {link:<8} {a['transfers']:>6} "
                f"{_fmt_qty(a['bytes']):>9} {a['rows']:>8} "
                f"{_fmt_s(a['send_s']):>9} "
                f"{_fmt_s(a['one_sided_wait_s']):>14}  "
                + ",".join(a["tags"])
            )
    health = (
        f"  p2p health: {p2p.get('matched', 0)} correlated pairs, "
        f"{p2p.get('unmatched', 0)} unmatched"
    )
    if p2p.get("duplicate_correlations"):
        health += f", {p2p['duplicate_correlations']} DUPLICATE ids"
    if p2p.get("heartbeats"):
        health += f", {p2p['heartbeats']} blocked-recv heartbeats"
    lines.append(health)
    if p2p.get("unmatched"):
        lines.append(
            "  WARNING: unmatched correlated events — a torn exchange "
            "mesh, a missing shard file, or a truncated run"
        )
    rc = fs.get("re_combine") or {}
    if rc:
        lines.append(
            "  re-combine: "
            f"{_fmt_qty(rc['bytes_sent_total'])}B total"
            + (f" (mode {rc['mode']})" if rc.get("mode") else "")
            + "  "
            + "  ".join(
                f"p{k} {_fmt_qty(v)}B"
                for k, v in sorted(rc["per_process"].items())
            )
        )
    # feature-range sharding at fleet granularity: count/balance are
    # replicated, widths and local nnz are per-range — show the spread
    fe_pp = {
        k: (s.get("fe_shard") or {})
        for k, s in (fs.get("processes") or {}).items()
        if (s.get("fe_shard") or {}).get("ranges")
    }
    if fe_pp:
        first = next(iter(fe_pp.values()))
        widths = [
            v.get("width") for v in fe_pp.values()
            if isinstance(v.get("width"), (int, float))
        ]
        lines.append(
            f"  fe-shard: {int(first.get('ranges') or 0)} ranges, "
            f"nnz balance {float(first.get('nnz_balance') or 1.0):.3f}x"
            + (
                f", widths {min(widths):.0f}..{max(widths):.0f}"
                if widths else ""
            )
        )
    prj = fs.get("re_project") or {}
    if prj:
        ratio = prj.get("mean_ratio")
        lines.append(
            "  re-project:"
            + (f" mode {prj['mode']}," if prj.get("mode") else "")
            + (
                f" mean width ratio {ratio:.3f}"
                if isinstance(ratio, (int, float)) else ""
            )
        )
        for c in prj.get("classes") or []:
            lines.append(
                f"    class C={int(c.get('capacity', 0))}: "
                f"support {int(c.get('support_dim', 0))} -> "
                f"dim {int(c.get('dim', 0))}"
                + (" (hashed)" if c.get("hashed") else "")
            )
    sv = fs.get("serve") or {}
    if sv.get("requests_total"):
        p50m, p99m = sv.get("latency_p50_ms_max"), sv.get(
            "latency_p99_ms_max"
        )
        hr = sv.get("hot_hit_rate")
        lines.append(
            f"  serve: {int(sv['requests_total'])} requests, "
            f"{int(sv.get('forwarded_total') or 0)} cross-owner forwards, "
            f"{int(sv.get('refreshes_total') or 0)} refreshes"
        )
        lines.append(
            "    worst-process tail: "
            + (
                f"p50 {p50m:.2f} ms / p99 {p99m:.2f} ms"
                if isinstance(p50m, (int, float))
                and isinstance(p99m, (int, float)) else _UNRECORDED
            )
            + (
                f", traffic-weighted hot hit rate {hr:.3f}"
                if isinstance(hr, (int, float)) else ""
            )
        )
    stm = fs.get("stream") or {}
    if stm:
        lines.append(
            f"  stream executor: "
            f"{_fmt_qty(stm.get('cache_hit_bytes_total') or 0.0)}B hit "
            f"({_fmt_qty(stm.get('cache_shared_hit_bytes_total') or 0.0)}B "
            f"shared) / "
            f"{_fmt_qty(stm.get('cache_miss_bytes_total') or 0.0)}B miss "
            f"across {len(stm.get('per_process') or {})} process(es)"
        )
    for rp in fs.get("replans") or []:
        procs = rp.get("processes") or []
        lines.append(
            f"  re-plan: iter {rp['iteration']} {rp['coordinate']}: "
            "measured imbalance "
            + (
                f"{rp['imbalance']:.2f}x"
                if isinstance(rp.get("imbalance"), (int, float))
                else "?"
            )
            + f" → migrated {rp.get('migrated')} entities "
            + f"(observed by {len(procs)} process"
            + ("es)" if len(procs) != 1 else ")")
        )
    rec = fs.get("recovery") or {}
    if any(
        rec.get(k)
        for k in (
            "p2p_retries", "p2p_giveups", "drain_errors",
            "faults_injected", "peer_lost", "recoveries",
            "degraded_descents", "rejoins",
        )
    ):
        seg = (
            f"  retry/recovery: {rec.get('p2p_retries', 0)} retries"
        )
        errs = rec.get("retry_errors") or {}
        if errs:
            seg += (
                " ("
                + ", ".join(f"{k}×{v}" for k, v in errs.items())
                + ")"
            )
        seg += (
            f", {rec.get('p2p_giveups', 0)} giveups, "
            f"{rec.get('drain_errors', 0)} drain errors, "
            f"{rec.get('faults_injected', 0)} injected faults"
        )
        lines.append(seg)
        for pl in rec.get("peer_lost") or []:
            lines.append(
                f"    peer_lost: p{pl['process']} lost peer "
                f"{pl['peer']}"
            )
        for rv in rec.get("recoveries") or []:
            lines.append(
                f"    recovery: p{rv['process']} resumed with "
                f"survivors {rv['survivors']} (lost {rv['lost']})"
            )
        for dd in rec.get("degraded_descents") or []:
            lines.append(
                f"    degraded_descent: p{dd['process']} degraded IN "
                f"PLACE at iteration {dd['iteration']} — survivors "
                f"{dd['survivors']} (lost {dd['lost']}, no restart)"
            )
        for rj in rec.get("rejoins") or []:
            mig = rj.get("migrated")
            mig_s = (
                "" if not mig
                else " — migrated back: " + ", ".join(
                    f"{c}:{n}" for c, n in sorted(mig.items())
                )
            )
            lines.append(
                f"    rejoin: p{rj['process']} ({rj.get('role')}) — "
                f"{rj.get('rejoined')} rejoined, group {rj.get('group')}"
                + mig_s
            )
        if rec.get("recoveries") or rec.get("degraded_descents"):
            lines.append(
                "  WARNING: this run degraded mid-flight — wall/"
                "imbalance rows mix pre- and post-recovery topologies"
            )
    if fs["knobs"]:
        lines.append(f"  knobs: {json.dumps(fs['knobs'], sort_keys=True)}")
    return "\n".join(lines)


# -- regression gate --------------------------------------------------------
#
# ``photon-ml-tpu-torch report gate RUN --baseline BASE`` turns the telemetry
# artifact from a passive record into an active tripwire: a flat metric
# dict is extracted from each side (telemetry run JSONL, bench JSON doc,
# or a saved gate-baseline file), every baseline metric is compared
# against the current run under a per-metric threshold, and any breach
# exits nonzero. Thresholds are tiered by what the metric IS: analytic
# cost numbers (devcost flops/bytes) are deterministic for a given
# compiler, so they gate TIGHT; wall-clock metrics are noisy, so they
# gate loose. Regressions are one-sided — fewer bytes/flops/seconds is
# never a failure.

GATE_SCHEMA_VERSION = 1

# pattern -> {"rel": fractional headroom, "abs": additive headroom};
# longest matching substring wins, "" is the default tier
DEFAULT_GATE_THRESHOLDS: dict[str, dict] = {
    "": {"rel": 0.25},
    # wall-clock tiers: real time on shared CI boxes jitters hard
    "wall_s": {"rel": 1.0, "abs": 10.0},
    "compile_s": {"rel": 2.0, "abs": 10.0},
    "transfer_s": {"rel": 1.0, "abs": 5.0},
    "host_pack_s": {"rel": 1.0, "abs": 5.0},
    "consumer_wait_s": {"rel": 2.0, "abs": 5.0},
    "capture_s": {"rel": 4.0, "abs": 10.0},
    # analytic tiers: byte/flop counts move only when code or knobs move
    "devcost/": {"rel": 0.02},
    "packed_stream_bytes": {"rel": 0.01},
    "hbm/": {"rel": 0.10},
    # placement tiers: every planner readout (balance ratios, rows_max)
    # is deterministic for a given planner + row distribution, so the
    # whole re_shard/ family gates TIGHT — a regression is a planner
    # change. The overlap ratio (longest-substring match wins over the
    # prefix tier) is bounded in [0, 1] and higher-is-better, so it
    # gates on PRESENCE only: abs 1.0 headroom can never fail on a
    # value, but a missing gauge still FAILs — losing the instrument
    # must trip the gate.
    "re_shard/": {"rel": 0.05},
    "re_shard/exchange_overlap_ratio": {"abs": 1.0},
    # sub-bucket placement tiers (PHOTON_RE_SPLIT runs only — unsplit
    # runs never emit these keys, so their thresholds are unchanged):
    # the atom ladder is exact deterministic arithmetic on the global
    # bincount, and at atom granularity the LPT balance has far less
    # excuse to drift than the whole-class plan — tight tier
    "re_shard/atoms": {"rel": 0.0, "abs": 0.0},
    "re_shard/balance_split": {"rel": 0.02},
    # device-granularity placement tiers (PHOTON_RE_DEVICE_SPLIT runs
    # only): the per-device LPT is deterministic on the owned-atom
    # weights, so the balance gates tight like balance_split; the
    # launch schedule is exact deterministic fusion-unit arithmetic —
    # one extra launch is a schedule regression, not noise
    "re_shard/device_balance": {"rel": 0.02},
    "re_solve/launches": {"rel": 0.0, "abs": 0.0},
    # combine-traffic tier: bytes per process are deterministic for a
    # given combine mode + placement, so near-tight — a 5% creep is a
    # packing/layout regression, and a mode accidentally falling back
    # to the dense arm shows up as a multiple, not a percent
    "re_combine/": {"rel": 0.05},
    # re-plan tier: exact headroom — like every gate this is ONE-SIDED
    # (cur > baseline fails), so a SPONTANEOUS migration against a
    # healthy baseline trips; the vanishing direction (a straggler
    # drill that stops migrating) is covered by the slow gloo drill's
    # own assertion, not the gate
    "re_replan/migrations": {"rel": 0.0, "abs": 0.0},
    # fleet tiers (the merged cross-process view from ``report fleet``):
    # telemetry-health counts gate EXACT — one unmatched correlated
    # event or one missing shard is a broken instrument, not noise —
    # while wall-derived imbalance gates loose (CPU scheduling jitter
    # moves a 2-process toy run's phase ratios hard). P2P bytes are
    # deterministic for a given router + row distribution: near-tight.
    "fleet/missing_shards": {"rel": 0.0, "abs": 0.0},
    "fleet/unmatched_p2p": {"rel": 0.0, "abs": 0.0},
    "fleet/p2p_bytes_total": {"rel": 0.05},
    # retry/recovery tiers (PR-11 fault-tolerance): a chaos baseline's
    # injected-fault retries may jitter up slightly (scheduler timing
    # can split one backoff into two attempts), but any NEW giveup,
    # drain error, peer loss or recovery is a new failure mode
    "fleet/p2p_retries": {"rel": 1.0, "abs": 2.0},
    "fleet/p2p_giveups": {"rel": 0.0, "abs": 0.0},
    "fleet/exchange_drain_errors": {"rel": 0.0, "abs": 0.0},
    "fleet/peer_lost": {"rel": 0.0, "abs": 0.0},
    "fleet/recoveries": {"rel": 0.0, "abs": 0.0},
    # elastic-fleet tiers: in-place descent degrades and rejoins are
    # deterministic for a committed fault plan — one extra of either is
    # a new failure mode (or a spontaneous rejoin against a healthy
    # baseline), never noise
    "fleet/degraded_descents": {"rel": 0.0, "abs": 0.0},
    "fleet/rejoins": {"rel": 0.0, "abs": 0.0},
    "/imbalance": {"rel": 1.0, "abs": 1.0},
    "exchange_wait_s": {"rel": 2.0, "abs": 5.0},
    "exchange_s": {"rel": 2.0, "abs": 5.0},
    # projection tier (PHOTON_RE_PROJECT runs only — unprojected runs
    # never emit these keys): the mean solved-width ratio is exact
    # deterministic arithmetic on the global activity bincount, so it
    # gates TIGHT — a >2% widening means the ladder (or the data's
    # sparsity structure) changed
    "re_project/": {"rel": 0.02},
    # feature-range sharding tiers (PHOTON_FE_SHARD runs only —
    # unsharded runs never emit these keys): the range count is exact
    # planner arithmetic (one extra range is a planner change, not
    # noise) and the nnz balance is deterministic on the histogram, so
    # it gates as tight as the placement balances above
    "fe_shard/": {"rel": 0.05},
    "fe_shard/ranges": {"rel": 0.0, "abs": 0.0},
    "fe_shard/nnz_balance": {"rel": 0.02},
    # serving tiers (bench --serve / serving runs only): wall-clock
    # latency percentiles jitter like every wall tier, so they gate
    # LOOSE; the hot-set hit rate and mean window occupancy are bounded
    # [0, 1] ratios that gate on PRESENCE (losing the instrument trips,
    # a value never does — the >= 0.8 acceptance floor is the bench
    # doc's own assertion, not the gate's); the two parity flags are
    # bitwise contracts, so they gate EXACT — a refresh that stops
    # matching its offline solve, or a serve path that stops matching
    # the batch score driver, is a correctness break, never noise
    "serve/latency": {"rel": 1.0, "abs": 10.0},
    "serve/hot_hit_rate": {"abs": 1.0},
    "serve/window_occupancy": {"abs": 1.0},
    "serve/refresh_parity": {"rel": 0.0, "abs": 0.0},
    "serve/score_parity": {"rel": 0.0, "abs": 0.0},
    # streaming-executor tiers (PHOTON_STREAM_EXECUTOR runs only —
    # executor-off runs never emit stream/* keys, so every committed
    # baseline stays valid unchanged): arbiter transfer bytes are
    # chunk-shape arithmetic but depend on eviction timing under
    # pressure, so they gate LOOSE; the stream parity flags (bench
    # X_stream) are bitwise contracts and gate EXACT
    "stream/": {"rel": 0.5},
    "stream/cache_evictions": {"rel": 1.0, "abs": 8.0},
    "stream/parity": {"rel": 0.0, "abs": 0.0},
    # quality tiers: deltas vs the f32 anchor, absolute headroom at the
    # parity-gate scale (|ΔAUC| ≤ 0.005 is the ladder's own bf16 gate)
    "quality/": {"rel": 0.0, "abs": 0.005},
    "optim/iterations": {"rel": 0.25, "abs": 2.0},
    "warnings": {"rel": 0.0, "abs": 0.0},
}


def _fmt_gate(v: float | None) -> str:
    """Gate-table cell format: engineering suffixes for big counts, but
    full precision below 1 — the quality/* tier lives at 1e-3..1e-6 and
    ``_fmt_qty`` would render every such value (and its limit) as '0',
    hiding by how much a parity gate was breached."""
    if v is None:
        return "-"
    v = float(v)
    if abs(v) >= 1000:
        return _fmt_qty(v)
    return f"{v:.6g}"


def resolve_threshold(metric: str, thresholds: dict) -> dict:
    """Longest substring-matching pattern wins; ``""`` is the default.
    An explicitly-empty rule (``{}``) is a valid exact gate (no
    headroom), so resolution checks for None, never truthiness."""
    best = ""
    for p in thresholds:
        if p and p in metric and len(p) > len(best):
            best = p
    rule = thresholds.get(best)
    if rule is None:
        rule = thresholds.get("")
    return rule if rule is not None else {"rel": 0.25}


def _qp_metrics(qp: dict, prefix: str = "") -> dict:
    m = {}
    if not qp:
        return m
    for k in ("auc_delta", "loss_rel_delta"):
        if isinstance(qp.get(k), (int, float)):
            m[f"{prefix}quality/{k}_abs"] = abs(float(qp[k]))
    if isinstance(qp.get("margins_rmse_vs_f32"), (int, float)):
        m[f"{prefix}quality/margins_rmse_vs_f32"] = float(
            qp["margins_rmse_vs_f32"]
        )
    return m


def gate_metrics_from_summary(s: dict) -> dict[str, float]:
    """Flatten one telemetry-run summary into gateable metrics."""
    m: dict[str, float] = {}
    for k in ("wall_s", "compile_s", "transfer_s", "host_pack_s",
              "consumer_wait_s", "exchange_s", "exchange_wait_s"):
        # exchange_s/exchange_wait_s exist only on runs that recorded
        # the overlapped-exchange timers; a pre-fleet baseline simply
        # never lists them, so old-vs-new gates stay comparable
        if isinstance(s.get(k), (int, float)):
            m[k] = float(s[k])
    for lab, agg in (s.get("devcost") or {}).items():
        m[f"devcost/{lab}/flops"] = float(agg.get("flops") or 0.0)
        m[f"devcost/{lab}/bytes_accessed"] = float(
            agg.get("bytes_accessed") or 0.0
        )
        if agg.get("peak_bytes"):
            m[f"devcost/{lab}/peak_bytes"] = float(agg["peak_bytes"])
    rsh = s.get("re_shard") or {}
    for k, v in rsh.items():
        if k in ("balance", "rows_max", "exchange_overlap_ratio",
                 "device_balance"):
            m[f"re_shard/{k}"] = float(v)
    if float(rsh.get("split_classes") or 0) > 0:
        # sub-bucket placement (PHOTON_RE_SPLIT) ran: gate the atom
        # count exactly and the balance on the TIGHT split tier — at
        # atom granularity the planner has no excuse for a worse ratio.
        # Unsplit runs never emit these keys, so their thresholds (and
        # committed baselines) are unchanged.
        m["re_shard/atoms"] = float(rsh.get("atoms") or 0)
        m["re_shard/balance_split"] = float(rsh.get("balance") or 1.0)
    fsh = s.get("fe_shard") or {}
    if float(fsh.get("ranges") or 0) > 0:
        # feature-range sharding ran: the range count is exact planner
        # arithmetic and the nnz balance is deterministic on the
        # histogram, so both gate tight. Unsharded runs never emit
        # these keys — their baselines are unchanged.
        m["fe_shard/ranges"] = float(fsh.get("ranges") or 0)
        m["fe_shard/nnz_balance"] = float(fsh.get("nnz_balance") or 1.0)
    rc = s.get("re_combine") or {}
    if isinstance(rc.get("bytes_sent"), (int, float)):
        m["re_combine/bytes_sent"] = float(rc["bytes_sent"])
    prj = s.get("re_project") or {}
    if isinstance(prj.get("mean_ratio"), (int, float)):
        # lower-is-better and deterministic: the tight re_project/ tier
        # catches any widening; dims_saved_bytes is higher-is-better so
        # it rides the report narrative, not the one-sided gate
        m["re_project/mean_ratio"] = float(prj["mean_ratio"])
    rp = s.get("re_replan") or {}
    if rp:
        # exact one-sided tier: a migration APPEARING against the
        # baseline is a planner-behavior change, not noise
        m["re_replan/migrations"] = float(rp.get("migrations") or 0)
    sv = s.get("serve") or {}
    if sv.get("requests"):
        # serving tiers: latency gates loose (wall), the bounded ratios
        # gate on presence — losing the instrument trips, a value never
        # does. Non-serving runs never emit these keys.
        if isinstance(sv.get("latency_p50_ms"), (int, float)):
            m["serve/latency_p50_ms"] = float(sv["latency_p50_ms"])
        if isinstance(sv.get("latency_p99_ms"), (int, float)):
            m["serve/latency_p99_ms"] = float(sv["latency_p99_ms"])
        if isinstance(sv.get("hot_hit_rate"), (int, float)):
            m["serve/hot_hit_rate"] = float(sv["hot_hit_rate"])
        if isinstance(sv.get("window_occupancy_mean"), (int, float)):
            m["serve/window_occupancy"] = float(
                sv["window_occupancy_mean"]
            )
    stm = s.get("stream") or {}
    if stm.get("streams") or stm.get("cache_miss_bytes"):
        # executor tiers: miss bytes (the actual transfer traffic the
        # arbiter paid) and evictions are lower-is-better and gate on
        # the loose stream/ tier; hit bytes are higher-is-better so
        # they ride the report narrative, not the one-sided gate.
        # Executor-off runs never emit these keys.
        m["stream/cache_miss_bytes"] = float(
            stm.get("cache_miss_bytes") or 0
        )
        m["stream/cache_evictions"] = float(
            stm.get("cache_evictions") or 0
        )
    m.update(_qp_metrics(s.get("quality_parity") or {}))
    o = s.get("optim") or {}
    if o.get("solves"):
        m["optim/iterations"] = float(o.get("iterations") or 0)
    m["warnings"] = float(s.get("warnings") or 0)
    hbm = s.get("hbm") or {}
    if hbm.get("peak_bytes_in_use"):
        m["hbm/peak_bytes_in_use"] = float(hbm["peak_bytes_in_use"])
    return m


def gate_metrics_from_bench(doc: dict) -> dict[str, float]:
    """Flatten a ``bench.py`` JSON document (the ``--quick`` single-line
    contract, or one ``--config`` child's result) into gateable metrics,
    namespaced per config. Reads the telemetry block's ``devcost.*`` /
    ``hbm.*`` gauges, the compile timer, the quality-parity gate and the
    per-rung packed-stream bytes — everything a dtype or schedule sweep
    would want tripwired."""
    configs = doc.get("configs")
    if configs is None:
        configs = {"config": doc}
    m: dict[str, float] = {}
    for cfg, r in configs.items():
        if not isinstance(r, dict) or "error" in r:
            continue  # its baseline metrics then read as MISSING -> fail
        tel = r.get("telemetry") or {}
        tmetrics = tel.get("metrics") or {}
        for g, v in (tmetrics.get("gauges") or {}).items():
            if g.startswith("devcost."):
                m[f"{cfg}/devcost/{g[len('devcost.'):]}"] = float(v)
            elif g.startswith("hbm.") and g != "hbm.budget_queried":
                m[f"{cfg}/hbm/{g[len('hbm.'):]}"] = float(v)
            elif g.startswith("re_shard.") and g in (
                "re_shard.balance",
                "re_shard.rows_max",
                "re_shard.round_robin_balance",
                "re_shard.exchange_overlap_ratio",
                "re_shard.device_balance",
            ):
                m[f"{cfg}/re_shard/{g[len('re_shard.'):]}"] = float(v)
            elif g in ("fe_shard.ranges", "fe_shard.nnz_balance"):
                # feature-range sharding readouts (the per-process width
                # and nnz ride the narrative, not the one-sided gate)
                m[f"{cfg}/{g.replace('.', '/', 1)}"] = float(v)
            elif g in ("serve.latency_p50_ms", "serve.latency_p99_ms"):
                # serving latency gauges (loose wall tier via the
                # serve/latency substring)
                m[f"{cfg}/serve/latency{g[len('serve.latency'):]}"] = (
                    float(v)
                )
            elif g == "serve.hot.hit_rate":
                m[f"{cfg}/serve/hot_hit_rate"] = float(v)
            elif g == "serve.window.occupancy_mean":
                m[f"{cfg}/serve/window_occupancy"] = float(v)
        gauges = tmetrics.get("gauges") or {}
        if float(gauges.get("re_shard.split_classes") or 0) > 0:
            # split-granularity tier (mirrors gate_metrics_from_summary)
            m[f"{cfg}/re_shard/atoms"] = float(
                gauges.get("re_shard.atoms") or 0
            )
            m[f"{cfg}/re_shard/balance_split"] = float(
                gauges.get("re_shard.balance") or 1.0
            )
        timers = tmetrics.get("timers") or {}
        if "cuda.build_s" in timers:
            m[f"{cfg}/compile_s"] = float(
                timers["cuda.build_s"].get("seconds") or 0.0
            )
        m.update(
            _qp_metrics(
                tel.get("quality_parity") or r.get("quality_parity") or {},
                prefix=f"{cfg}/",
            )
        )
        if isinstance(r.get("packed_stream_bytes_per_pass"), (int, float)):
            m[f"{cfg}/packed_stream_bytes_per_pass"] = float(
                r["packed_stream_bytes_per_pass"]
            )
        if isinstance(r.get("sec_per_solve"), (int, float)):
            m[f"{cfg}/wall_s"] = float(r["sec_per_solve"])
    return m


def gate_metrics_from_fleet(fs: dict) -> dict[str, float]:
    """Flatten a ``summarize_fleet`` view into gateable metrics — the
    whole-fleet gate the multichip sweeps use, so a balance/overlap
    regression on process 3 trips even though process 0's own summary
    looks fine. Telemetry-health counts (missing shards, unmatched
    correlated events) gate exact; per-phase imbalance and exchange wait
    gate loose (wall-derived); the overlap ratio gates on PRESENCE via
    the standard ``re_shard/exchange_overlap_ratio`` tier, taken as the
    fleet MINIMUM (the worst process is the one a regression hides in)."""
    m: dict[str, float] = {
        "fleet/processes": float(fs.get("process_count") or 0),
        "fleet/missing_shards": float(fs.get("missing_shards") or 0),
        "fleet/unmatched_p2p": float(
            (fs.get("p2p") or {}).get("unmatched") or 0
        ),
        "fleet/wall_s": float(fs.get("wall_s") or 0.0),
    }
    p2p = fs.get("p2p") or {}
    if p2p.get("links"):
        m["fleet/p2p_bytes_total"] = float(
            sum(a["bytes"] for a in p2p["links"].values())
        )
    rec = fs.get("recovery") or {}
    if rec:
        # retry/recovery tier: retries gate LOOSE against a chaos
        # baseline (the committed fault plan fixes the floor, scheduler
        # jitter can add a few); giveups, drain errors, peer losses and
        # recoveries gate EXACT — an extra one of any of these is a new
        # failure mode, not noise
        m["fleet/p2p_retries"] = float(rec.get("p2p_retries") or 0)
        m["fleet/p2p_giveups"] = float(rec.get("p2p_giveups") or 0)
        m["fleet/exchange_drain_errors"] = float(
            rec.get("drain_errors") or 0
        )
        m["fleet/peer_lost"] = float(len(rec.get("peer_lost") or []))
        m["fleet/recoveries"] = float(len(rec.get("recoveries") or []))
        m["fleet/degraded_descents"] = float(
            len(rec.get("degraded_descents") or [])
        )
        m["fleet/rejoins"] = float(len(rec.get("rejoins") or []))
    for ph, agg in (fs.get("phases") or {}).items():
        if agg.get("imbalance") is not None:
            m[f"fleet/phase/{ph}/imbalance"] = float(agg["imbalance"])
    if fs.get("overlap"):
        m["re_shard/exchange_overlap_ratio"] = float(
            min(fs["overlap"].values())
        )
    for k, e in (fs.get("exchange") or {}).items():
        m[f"fleet/p{k}/exchange_wait_s"] = float(e["wait_s"])
    # placement readouts are identical on every process; gate the fleet
    # MAX so one disagreeing shard (itself a bug) can only look worse
    for name in ("balance", "rows_max"):
        v = _re_shard_fleet_max(fs, name)
        if v is not None:
            m[f"re_shard/{name}"] = v
    # device-level sub-plan: loads are process-LOCAL, so the gateable
    # scalar is the fleet MAX of the per-process intra-host balance
    # (the worst host is the one a placement regression hides in)
    v = _re_shard_fleet_max(fs, "device_balance")
    if v is not None:
        m["re_shard/device_balance"] = v
    if (_re_shard_fleet_max(fs, "split_classes") or 0) > 0:
        # split-granularity tier, fleet-wide (mirrors the per-run gate)
        m["re_shard/atoms"] = float(_re_shard_fleet_max(fs, "atoms") or 0)
        m["re_shard/balance_split"] = float(
            _re_shard_fleet_max(fs, "balance") or 1.0
        )
    # combine traffic gates the fleet TOTAL (near-tight: deterministic
    # for a given mode + placement); migrations gate the fleet MAX of
    # the per-process counter — every process counts the same global
    # number, so one disagreeing shard can only look worse (exact tier)
    rc = fs.get("re_combine") or {}
    if isinstance(rc.get("bytes_sent_total"), (int, float)):
        m["re_combine/bytes_sent"] = float(rc["bytes_sent_total"])
    # feature-range sharding: range count and nnz balance are
    # replicated (deterministic planner on the allreduced histogram),
    # so gate the fleet MAX — a disagreeing shard can only look worse
    for name in ("ranges", "nnz_balance"):
        vals = [
            (s.get("fe_shard") or {}).get(name)
            for s in (fs.get("processes") or {}).values()
        ]
        vals = [float(v) for v in vals if isinstance(v, (int, float))]
        if vals:
            m[f"fe_shard/{name}"] = max(vals)
    # the projection ratio gates the fleet MAX of the per-process gauge
    # (replicated ladder: a disagreeing shard can only look worse)
    prj = fs.get("re_project") or {}
    if isinstance(prj.get("mean_ratio"), (int, float)):
        m["re_project/mean_ratio"] = float(prj["mean_ratio"])
    mig = [
        (s.get("re_replan") or {}).get("migrations")
        for s in (fs.get("processes") or {}).values()
    ]
    mig = [float(v) for v in mig if isinstance(v, (int, float))]
    if mig:
        m["re_replan/migrations"] = max(mig)
    # serving: the gateable tail is the WORST process's percentile (an
    # SLO is a max), the hit rate the traffic-weighted fleet value —
    # both on the per-run serve tiers; non-serving fleets emit nothing
    sv = fs.get("serve") or {}
    if sv:
        if isinstance(sv.get("latency_p50_ms_max"), (int, float)):
            m["serve/latency_p50_ms"] = float(sv["latency_p50_ms_max"])
        if isinstance(sv.get("latency_p99_ms_max"), (int, float)):
            m["serve/latency_p99_ms"] = float(sv["latency_p99_ms_max"])
        if isinstance(sv.get("hot_hit_rate"), (int, float)):
            m["serve/hot_hit_rate"] = float(sv["hot_hit_rate"])
    return m


def load_gate_metrics(
    path: str, fleet: bool = False
) -> tuple[str, dict[str, float]]:
    """(kind, metrics) from any gate-readable artifact: a telemetry run
    JSONL (or a telemetry DIR — newest run wins), a ``bench.py`` JSON
    document, or a gate-baseline file written by ``report gate
    --write-baseline``. ``fleet=True`` loads a telemetry run (file or
    dir) as the MERGED fleet view — canonical file plus every ``.p<k>``
    shard — instead of process 0's summary alone; saved gate-baseline
    files still load as baselines."""
    if fleet:
        doc = None
        if not os.path.isdir(path):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except json.JSONDecodeError:
                doc = None
        if isinstance(doc, dict) and doc.get("gate_baseline"):
            return "baseline", {
                k: float(v) for k, v in (doc.get("metrics") or {}).items()
                if isinstance(v, (int, float))
            }
        if isinstance(doc, dict) and (
            "configs" in doc or "telemetry" in doc
        ) and doc.get("event") != "run_start":
            # the EITHER-side contract holds under --fleet too: a
            # bench.py JSON document is a valid (non-fleet) side
            return "bench", gate_metrics_from_bench(doc)
        return "fleet", gate_metrics_from_fleet(
            summarize_fleet(fleet_run_paths(path))
        )
    if os.path.isdir(path):
        run = latest_run(path)
        if run is None:
            raise ValueError(f"no run-*.jsonl files in {path}")
        path = run
    doc = None
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError:
        doc = None  # multi-record JSONL -> telemetry run
    if isinstance(doc, dict) and doc.get("gate_baseline"):
        return "baseline", {
            k: float(v) for k, v in (doc.get("metrics") or {}).items()
            if isinstance(v, (int, float))
        }
    if isinstance(doc, dict) and (
        "configs" in doc or "telemetry" in doc
    ) and doc.get("event") != "run_start":
        return "bench", gate_metrics_from_bench(doc)
    return "telemetry", gate_metrics_from_summary(summarize_run(path))


def gate_run(
    current: dict[str, float],
    baseline: dict[str, float],
    thresholds: dict | None = None,
    allow_missing: bool = False,
) -> tuple[list[dict], list[str]]:
    """Compare ``current`` against every ``baseline`` metric. Returns
    ``(failures, report_lines)``; empty failures = gate passes. A metric
    present in the baseline but absent from the run is itself a failure
    (lost instrumentation reads as "covered" otherwise) unless
    ``allow_missing``; metrics only the current run has are informational
    (new instrumentation is not a regression)."""
    th = dict(DEFAULT_GATE_THRESHOLDS)
    th.update(thresholds or {})
    if not baseline:
        raise ValueError("baseline contains no gateable metrics")
    failures: list[dict] = []
    lines = [
        f"  {'metric':<58} {'baseline':>11} {'current':>11} "
        f"{'limit':>11}  ok",
    ]
    for name in sorted(baseline):
        base = baseline[name]
        rule = resolve_threshold(name, th)
        limit = base * (1.0 + float(rule.get("rel", 0.0))) + float(
            rule.get("abs", 0.0)
        )
        cur = current.get(name)
        if cur is None:
            if not allow_missing:
                failures.append(
                    {"metric": name, "problem": "missing",
                     "baseline": base, "limit": limit}
                )
            lines.append(
                f"  {name:<58} {_fmt_gate(base):>11} {'(missing)':>11} "
                f"{_fmt_gate(limit):>11}  "
                + ("SKIP" if allow_missing else "FAIL")
            )
            continue
        ok = cur <= limit
        if not ok:
            failures.append(
                {"metric": name, "problem": "regression",
                 "baseline": base, "current": cur, "limit": limit}
            )
        lines.append(
            f"  {name:<58} {_fmt_gate(base):>11} {_fmt_gate(cur):>11} "
            f"{_fmt_gate(limit):>11}  " + ("ok" if ok else "FAIL")
        )
    new = sorted(set(current) - set(baseline))
    if new:
        lines.append(f"  (+{len(new)} metrics not in baseline — ignored)")
    return failures, lines
