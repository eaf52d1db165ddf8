"""The port's knob registry: ONE source of truth per ``PHOTON_*``
environment knob the port reads (the counterpart of
``photon_ml_tpu/analysis/registry.py``).

Each knob declares its type, parse idiom, default, owning module,
call-time accessors, the module global that mirrors it, and which mirror
surfaces must carry it, with an explicit, reasoned exemption where a
surface does not apply. The ``photon-ml-tpu-torch lint`` knob pass
cross-checks every surface against this table BY PARSING THE SOURCES, so
drift in either direction fails the run. The port's surfaces:

- ``sink_key``: the key under which ``obs/sink._knob_snapshot`` must
  report the knob (the ``run_start`` configuration record), or None with
  a reason.
- devcost fingerprint: REQUIRED exactly when ``sink_key`` is set. The
  snapshot is memoized on ``obs/devcost._knob_raw_state``, so the knob's
  environment variable must be read there, or a mid-process flip of only
  that knob reuses a stale snapshot in capture keys.
- README: every registered knob appears in the port's generated README
  knob table (``photon-ml-tpu-torch lint --write-docs`` renders it between
  ``KNOB_TABLE_BEGIN`` / ``KNOB_TABLE_END``, markers that neither match
  nor are matched by the reference's).

The reference has a fourth surface, the bench's ``RETUNE_ENV*`` tables.
The port has no bench entry yet, so that surface is absent here as a
whole (not exempted knob by knob) until the port's bench names one; the
module globals the bench would retune are still declared
(``retune_global``), because the cache-keys pass flags reads of them
inside cached and captured bodies.

The reference's four TPU schedule constants (``PHOTON_GROUPS_PER_STEP``,
``_SEGMENTS_PER_DMA``, ``_GROUPS_PER_RUN``, ``_PIPELINE_SEGMENTS``) are
not registered: the port does not port them, and no port module reads
them.

``SNAPSHOT_CONSTANTS`` declares the snapshot keys that record fixed
constants of the kernels, not knobs: no variable sets them, so no knob
claims them, and the knob pass requires them in the snapshot as it
requires a knob's key.

Parse idioms (``parse``): ``strict_int`` / ``strict_float`` (``int(env)``
with no fallback: a typo fails the run loudly), ``enum`` (strict
membership in a value set), ``spec`` (a structured string with its own
strict parser), ``raw`` (a free string, path or JSON consumed verbatim;
truthiness is fine), ``lenient_warn`` (``PHOTON_DEVCOST`` degrades to
capture-off with one warning: observability must never take down the run
it observes).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str  # the PHOTON_* environment variable
    kind: str  # int | flag | float | enum | str | path | json | spec
    parse: str  # strict_int | strict_float | enum | spec | raw | lenient_warn
    default: str  # human-readable default
    owner: str  # repo-relative path of the owning module
    doc: str  # one-line description (README table row)
    accessors: tuple = ()  # call-time accessor function names
    retune_global: str | None = None  # module global that mirrors the knob
    sink_key: str | None = None
    exempt: tuple = ()  # ((surface, reason), ...) for absent surfaces
    alt: str | None = None  # a valid non-default value (sink knobs): the fingerprint must move under it

    def exempt_reason(self, surface: str) -> str | None:
        for s, reason in self.exempt:
            if s == surface:
                return reason
        return None

    @property
    def needs_devcost(self) -> bool:
        # the devcost fingerprint exists to invalidate the memoized sink
        # snapshot, so it must cover exactly the snapshot's inputs
        return self.sink_key is not None and self.exempt_reason("devcost") is None


#: snapshot keys that record fixed constants, not knobs: (key, reason)
SNAPSHOT_CONSTANTS: tuple[tuple[str, str], ...] = (
    ("k3_tile_nnz", "K3's nonzeros per tile, ``ops/sparse_tiled.TILE_NNZ``, fixed by ``kTileNnz`` in "
                    "csrc/sparse_tiled.cu; recorded so two runs' files show which tile size their layouts had"),
    ("k1_tiles_max_features_f32", "the widest float32 row K1's tiles layout takes "
                                  "(``ops/fused.TILES_MAX_FEATURES``), fixed by csrc/fused_glm.cu; recorded "
                                  "so a run's file says which layout a width took"),
    ("k1_tiles_max_features_bf16", "as k1_tiles_max_features_f32, for bfloat16 rows"),
)

_EXEMPT_FAULT = (
    ("sink", "does not change kernels or solve math; drills log their own fault/recovery telemetry events"),
)
_EXEMPT_TRANSPORT = (
    ("sink", "does not change kernels or solve math; retries/CRC emit their own p2p_* telemetry events"),
)
_EXEMPT_DEPLOY = (("sink", "deployment plumbing (addresses/paths): no effect on kernels or math"),)

_OPS = "photon_ml_tpu_torch/ops/"
_GAME = "photon_ml_tpu_torch/game/"
_PAR = "photon_ml_tpu_torch/parallel/"
_SERVE = "photon_ml_tpu_torch/serve/"

KNOBS: tuple[Knob, ...] = (
    # -- the kernels' storage rung and the fused path -----------------------------------
    Knob(
        name="PHOTON_KERNEL_DTYPE", kind="enum", parse="enum", default="f32", owner=_OPS + "sparse_tiled.py",
        doc="storage precision rung of K3's layouts: f32 (bitwise anchor) | bf16 | int8",
        accessors=("kernel_dtype",), retune_global="KERNEL_DTYPE", sink_key="kernel_dtype", alt="bf16",
    ),
    Knob(
        name="PHOTON_DISABLE_FUSED", kind="flag", parse="strict_int", default="0", owner=_OPS + "glm.py",
        doc="1 vetoes auto-selecting the fused K1/K2 kernels for dense CUDA batches",
        accessors=("fused_disabled",), sink_key="fused", alt="1",
    ),
    # -- host-ingest pipeline -------------------------------------------------------------
    Knob(
        name="PHOTON_PREFETCH_DEPTH", kind="int", parse="strict_int", default="2", owner=_OPS + "prefetch.py",
        doc="chunks prepared ahead of the consumer; 0 = synchronous",
        accessors=("prefetch_depth",), sink_key="prefetch_depth", alt="3",
    ),
    Knob(
        name="PHOTON_CHUNK_CACHE_BUDGET", kind="int", parse="strict_int", default="25% of device memory",
        owner=_OPS + "prefetch.py", doc="device-resident chunk-cache byte budget",
        accessors=("chunk_cache_budget_bytes",), sink_key="chunk_cache_budget_bytes", alt="1048576",
    ),
    # -- random-effect bucket solves ------------------------------------------------------
    Knob(
        name="PHOTON_RE_COMPACT_EVERY", kind="int", parse="strict_int", default="0",
        owner=_GAME + "random_effect.py", doc="outer iterations per compaction chunk; 0 = single launch",
        accessors=("compact_every",), retune_global="COMPACT_EVERY", sink_key="re_compact_every", alt="4",
    ),
    Knob(
        name="PHOTON_RE_FUSE_BUCKETS", kind="flag", parse="strict_int", default="0",
        owner=_GAME + "random_effect.py", doc="1 = fuse same-geometry buckets into one launch",
        accessors=("fuse_buckets",), retune_global="FUSE_BUCKETS", sink_key="re_fuse_buckets", alt="1",
    ),
    Knob(
        name="PHOTON_RE_COMBINE", kind="enum", parse="enum", default="allreduce",
        owner=_GAME + "random_effect.py", doc="cross-process combine transport: allreduce | segments",
        accessors=("re_combine_mode",), retune_global="RE_COMBINE", sink_key="re_combine", alt="segments",
    ),
    Knob(
        name="PHOTON_RE_PROJECT", kind="enum", parse="enum", default="0", owner=_GAME + "projector.py",
        doc="per-entity feature projection: 0 | support | hash",
        accessors=("re_project_mode",), retune_global="RE_PROJECT", sink_key="re_project", alt="support",
    ),
    Knob(
        name="PHOTON_RE_PROJECT_DIM", kind="int", parse="strict_int", default="32", owner=_GAME + "projector.py",
        doc="signed-hash fold width (pow2) for classes whose support exceeds it (hash mode only)",
        accessors=("re_project_dim",), retune_global="RE_PROJECT_DIM", sink_key="re_project_dim", alt="64",
    ),
    # -- entity-shard placement -----------------------------------------------------------
    Knob(
        name="PHOTON_RE_SHARD", kind="flag", parse="strict_int", default="0", owner=_PAR + "placement.py",
        doc="1 = skew-aware entity sharding + overlapped P2P exchange",
        accessors=("re_shard_enabled",), retune_global="RE_SHARD", sink_key="re_shard", alt="1",
    ),
    Knob(
        name="PHOTON_RE_SPLIT", kind="int", parse="strict_int", default="0", owner=_PAR + "placement.py",
        doc="sub-bucket atom target count; 0 = bucket-atomic placement",
        accessors=("re_split_factor",), retune_global="RE_SPLIT", sink_key="re_split", alt="8",
    ),
    Knob(
        name="PHOTON_RE_REPLAN_IMBALANCE", kind="float", parse="strict_float", default="0 (off)",
        owner=_PAR + "placement.py", doc="measured max/mean solve-wall ratio that triggers a re-plan",
        accessors=("replan_imbalance_threshold",), retune_global="REPLAN_IMBALANCE",
        sink_key="re_replan_imbalance", alt="1.5",
    ),
    Knob(
        name="PHOTON_RE_DEVICE_SPLIT", kind="flag", parse="strict_int", default="0", owner=_PAR + "placement.py",
        doc="1 = second-level LPT: owned atoms placed per LOCAL device",
        accessors=("re_device_split_enabled",), retune_global="RE_DEVICE_SPLIT", sink_key="re_device_split",
        alt="1",
    ),
    Knob(
        name="PHOTON_RE_SPLIT_WEIGHT", kind="enum", parse="enum", default="rows", owner=_PAR + "placement.py",
        doc="atom split/placement weight axis: rows | bytes",
        accessors=("re_split_weight",), retune_global="RE_SPLIT_WEIGHT", sink_key="re_split_weight", alt="bytes",
    ),
    # -- feature-range-sharded fixed effect ------------------------------------------------
    Knob(
        name="PHOTON_FE_SHARD", kind="flag", parse="strict_int", default="0",
        owner="photon_ml_tpu_torch/data/index_map.py",
        doc="1 = range-shard the fixed-effect feature space across processes",
        accessors=("fe_shard_enabled",), retune_global="FE_SHARD", sink_key="fe_shard", alt="1",
    ),
    Knob(
        name="PHOTON_FE_SPLIT_WEIGHT", kind="enum", parse="enum", default="nnz",
        owner="photon_ml_tpu_torch/data/index_map.py", doc="feature-range boundary weight axis: nnz | width",
        accessors=("fe_split_weight",), retune_global="FE_SPLIT_WEIGHT", sink_key="fe_split_weight", alt="width",
    ),
    # -- online serving -------------------------------------------------------------------
    Knob(
        name="PHOTON_SERVE_HOT_BYTES", kind="int", parse="strict_int", default="25% of RE model bytes",
        owner=_SERVE + "store.py", doc="hot-set byte budget for device-resident model shards",
        accessors=("serve_hot_budget_bytes",), retune_global="SERVE_HOT_BYTES", sink_key="serve_hot_bytes",
        alt="1048576",
    ),
    Knob(
        name="PHOTON_SERVE_MAX_BATCH", kind="int", parse="strict_int", default="32", owner=_SERVE + "router.py",
        doc="micro-window flush size (also the padded scoring shape)",
        accessors=("serve_max_batch",), retune_global="SERVE_MAX_BATCH", sink_key="serve_max_batch", alt="64",
    ),
    Knob(
        name="PHOTON_SERVE_MAX_WAIT_MS", kind="float", parse="strict_float", default="2.0",
        owner=_SERVE + "router.py", doc="oldest-request wait (ms) that forces a partial-window flush",
        accessors=("serve_max_wait_ms",), retune_global="SERVE_MAX_WAIT_MS", sink_key="serve_max_wait_ms",
        alt="5.0",
    ),
    Knob(
        name="PHOTON_SERVE_REFRESH_EVERY", kind="int", parse="strict_int", default="0 (off)",
        owner=_SERVE + "refresh.py", doc="buffered events per entity that trigger an incremental refresh",
        accessors=("serve_refresh_every",), retune_global="SERVE_REFRESH_EVERY", sink_key="serve_refresh_every",
        alt="16",
    ),
    # -- stream executor ------------------------------------------------------------------
    Knob(
        name="PHOTON_STREAM_EXECUTOR", kind="flag", parse="strict_int", default="0",
        owner=_OPS + "stream_executor.py",
        doc="1 = route streamed consumers through the shared executor "
            "(multi-tenant chunk-cache arbiter + cross-stream scheduling)",
        accessors=("stream_executor_enabled",), retune_global="STREAM_EXECUTOR", sink_key="stream_executor",
        alt="1",
    ),
    Knob(
        name="PHOTON_STREAM_PRIORITY", kind="spec", parse="spec",
        default="'' (built-in table: serve=100, refresh=10, rest=50)", owner=_OPS + "stream_executor.py",
        doc="per-consumer scheduling priority overrides, 'name=int,...'; higher preempts lower streams' "
            "prefetch depth",
        accessors=("stream_priority_spec", "priority_of"), retune_global="STREAM_PRIORITY",
        sink_key="stream_priority", alt="serve=90",
    ),
    Knob(
        name="PHOTON_STREAM_SHARE", kind="spec", parse="spec", default="'' (no per-consumer cap)",
        owner=_OPS + "stream_executor.py",
        doc="per-consumer chunk-cache budget shares, 'name=frac,...'; caps a stream's charged bytes at "
            "frac x the cache budget",
        accessors=("stream_share_spec", "share_fraction"), retune_global="STREAM_SHARE", sink_key="stream_share",
        alt="serve=0.5",
    ),
    # -- observability toggles ------------------------------------------------------------
    Knob(
        name="PHOTON_RE_ITER_ACCOUNTING", kind="flag", parse="strict_int", default="follows telemetry sink",
        owner=_GAME + "random_effect.py", doc="force per-lane iteration readback for re_solve.* counters",
        accessors=("iter_accounting_enabled",),
        exempt=(("sink", "changes only whether counters are read back, never kernels or math"),),
    ),
    Knob(
        name="PHOTON_TELEMETRY_FLEET", kind="flag", parse="strict_int", default="follows PHOTON_RE_SHARD",
        owner="photon_ml_tpu_torch/obs/sink.py", doc="per-process telemetry shards on processes 1..N-1",
        accessors=("fleet_telemetry_enabled",),
        exempt=(("sink", "configures the sink itself; recorded implicitly by which shard files exist"),),
    ),
    Knob(
        name="PHOTON_DEVCOST", kind="flag", parse="lenient_warn", default="follows telemetry sink",
        owner="photon_ml_tpu_torch/obs/devcost.py",
        doc="force analytic device-cost capture on (1, sink-less) or off (0)",
        accessors=("capture_enabled",),
        exempt=(("sink", "gates capture only; documented-lenient parse because observability must never "
                         "take down the run"),),
    ),
    # -- fault tolerance / elastic fleet ----------------------------------------------------
    Knob(
        name="PHOTON_DESCENT_DEGRADE", kind="flag", parse="strict_int", default="0", owner=_GAME + "descent.py",
        doc="1 = in-place degraded-group recovery for the in-memory descent",
        accessors=("descent_degrade_enabled",), exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_REJOIN", kind="flag", parse="strict_int", default="0", owner=_PAR + "multihost.py",
        doc="1 = elastic rejoin for the streamed trainer", accessors=("rejoin_enabled",), exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_REJOIN_WINDOW_S", kind="float", parse="strict_float", default="10", owner=_PAR + "multihost.py",
        doc="rejoin probe/invite window seconds", accessors=("rejoin_window_s",), exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_REJOIN_CMD", kind="json", parse="raw", default="unset", owner=_PAR + "faults.py",
        doc="argv (JSON list) used to re-exec a killed process", accessors=("rejoin_command",),
        exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_REJOIN_BOOT", kind="spec", parse="raw", default="unset", owner=_PAR + "multihost.py",
        doc="internal handshake: dying process's index for the rebooted child (set by the relauncher, not by "
            "operators)",
        exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_MESH_CACHE", kind="path", parse="raw", default="unset", owner=_PAR + "multihost.py",
        doc="persisted mesh-address cache enabling rejoin identity", accessors=("_mesh_cache_path",),
        exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_ROLLCALL_WINDOW_S", kind="float", parse="strict_float", default="10",
        owner=_PAR + "multihost.py", doc="roll-call census window seconds", exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_COORD_MAX_MISSING_HEARTBEATS", kind="int", parse="strict_int", default="unset (gloo default)",
        owner=_PAR + "multihost.py", doc="the gloo group's timeout in 10 s heartbeats",
        accessors=("coord_max_missing_heartbeats",), exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_FAULT_PLAN", kind="json", parse="raw", default="unset", owner=_PAR + "faults.py",
        doc="deterministic fault-injection plan (JSON list or @file)", accessors=("active_plan",),
        exempt=_EXEMPT_FAULT,
    ),
    Knob(
        name="PHOTON_RE_STRAGGLER", kind="spec", parse="spec", default="unset", owner=_PAR + "faults.py",
        doc="straggler drill: '<process>:<delay_s>' per-visit sleep", accessors=("straggler_spec",),
        exempt=_EXEMPT_FAULT,
    ),
    # -- framed-P2P transport -------------------------------------------------------------
    Knob(
        name="PHOTON_P2P_RETRIES", kind="int", parse="strict_int", default="0", owner=_PAR + "multihost.py",
        doc="reliable-exchange retry budget; 0 = raise on first link error", accessors=("_p2p_retries",),
        exempt=_EXEMPT_TRANSPORT,
    ),
    Knob(
        name="PHOTON_P2P_BACKOFF_S", kind="float", parse="strict_float", default="0.5", owner=_PAR + "multihost.py",
        doc="base exponential backoff between exchange retries", accessors=("_p2p_backoff_s",),
        exempt=_EXEMPT_TRANSPORT,
    ),
    Knob(
        name="PHOTON_P2P_CRC", kind="flag", parse="strict_int", default="0", owner=_PAR + "multihost.py",
        doc="advertise CRC32-trailed frame protocol v1 at mesh build", accessors=("_p2p_crc_enabled",),
        exempt=_EXEMPT_TRANSPORT,
    ),
    Knob(
        name="PHOTON_P2P_TIMEOUT_S", kind="float", parse="strict_float", default="300", owner=_PAR + "multihost.py",
        doc="per-socket-operation timeout for the exchange mesh", accessors=("_p2p_timeout_s",),
        exempt=_EXEMPT_TRANSPORT,
    ),
    Knob(
        name="PHOTON_P2P_HEARTBEAT_S", kind="float", parse="strict_float", default="5", owner=_PAR + "multihost.py",
        doc="blocked-recv heartbeat cadence for fleet telemetry", accessors=("_p2p_heartbeat_s",),
        exempt=_EXEMPT_TRANSPORT,
    ),
    # -- deployment plumbing --------------------------------------------------------------
    Knob(
        name="PHOTON_EXCHANGE_HOST", kind="str", parse="raw", default="derived from coordinator",
        owner=_PAR + "multihost.py", doc="explicit exchange-mesh bind/advertise host override",
        exempt=_EXEMPT_DEPLOY,
    ),
    Knob(
        name="PHOTON_ML_TPU_CACHE", kind="path", parse="raw", default="<tmpdir>/photon_ml_tpu_torch_native",
        owner="photon_ml_tpu_torch/native/build.py", doc="build cache directory for the native ingest library",
        accessors=("build_dir",), exempt=_EXEMPT_DEPLOY,
    ),
)


def sink_keys() -> set[str]:
    """The snapshot keys the registry claims: each sink knob's key and
    each declared constant."""
    return {k.sink_key for k in KNOBS if k.sink_key} | {key for key, _ in SNAPSHOT_CONSTANTS}


# -- README knob table (generated; photon-ml-tpu-torch lint --write-docs) -------------------
KNOB_TABLE_BEGIN = ("<!-- torch-knob-table:begin (generated from photon_ml_tpu_torch/analysis/registry.py — edit "
                    "there, then `photon-ml-tpu-torch lint --write-docs`) -->")
KNOB_TABLE_BEGIN_PREFIX = "<!-- torch-knob-table:begin"
KNOB_TABLE_END = "<!-- torch-knob-table:end -->"


def render_knob_table() -> str:
    """The port's README knob table, one row per registered knob.
    Regenerate with ``photon-ml-tpu-torch lint --write-docs``; the knob
    pass fails when the committed table and the registry disagree."""
    lines = [
        KNOB_TABLE_BEGIN,
        "| Knob | Kind | Default | Owner | Snapshot key | What it does |",
        "|---|---|---|---|---|---|",
    ]
    for k in KNOBS:
        sink = f"`{k.sink_key}`" if k.sink_key else "—"
        owner = k.owner.removeprefix("photon_ml_tpu_torch/")
        lines.append(f"| `{k.name}` | {k.kind} ({k.parse}) | {k.default} | `{owner}` | {sink} | {k.doc} |")
    lines.append(KNOB_TABLE_END)
    return "\n".join(lines)


def _validate_registry() -> None:
    """Import-time self-check: every knob either requires the snapshot or
    carries an explicit exemption reason, a snapshot knob names a valid
    non-default value, and no snapshot key is claimed twice."""
    seen: set[str] = set()
    keys: set[str] = set()
    for k in KNOBS:
        if k.name in seen:
            raise AssertionError(f"duplicate knob registration: {k.name}")
        seen.add(k.name)
        if k.sink_key is None and k.exempt_reason("sink") is None:
            raise AssertionError(f"{k.name}: no sink_key and no 'sink' exemption")
        if k.sink_key is not None:
            if k.alt is None:
                raise AssertionError(f"{k.name}: a snapshot knob needs a valid non-default value (alt)")
            if k.sink_key in keys:
                raise AssertionError(f"{k.name}: snapshot key {k.sink_key!r} claimed twice")
            keys.add(k.sink_key)
    for key, reason in SNAPSHOT_CONSTANTS:
        if key in keys or not reason:
            raise AssertionError(f"snapshot constant {key!r} is claimed by a knob or has no reason")
        keys.add(key)


_validate_registry()
