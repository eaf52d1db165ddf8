"""Reading telemetry runs: load, validate and find the files of a run
(the first part of a port of ``photon_ml_tpu/obs/report.py``).

``load_run`` parses one run's JSONL, ``validate_run`` checks it against
the schema the sink writes, and ``latest_run`` / ``fleet_run_paths`` find
a run's canonical file and its ``.p<k>`` shards. The summaries, diffs,
fleet view, gates and the ``report`` command are still to be ported; the
reference's ``photon-ml-tpu report`` reads a port run as it is (the
record kinds and fields are the reference's).
"""

from __future__ import annotations

import json
import os
import re

from photon_ml_tpu_torch.obs.sink import SCHEMA_VERSION

# fleet shard files: run-<id>.p<k>.jsonl (processes 1..N-1 of one run,
# beside process 0's canonical run-<id>.jsonl)
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
