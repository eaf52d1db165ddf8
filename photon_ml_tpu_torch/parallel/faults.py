"""Deterministic fault injection for the framed peer-to-peer transport
(port of ``photon_ml_tpu/parallel/faults.py``).

A fault plan (knob ``PHOTON_FAULT_PLAN``) names exactly which frame set
of which exchange on which link is dropped, corrupted, delayed or torn
down, or where a process dies, so the link layer's retries and backoff,
the CRC check, the heartbeat-to-timeout path and the peer-loss recovery
run through their whole state machines in tests and on the card with no
real flakiness. The grammar, the frame numbering and the telemetry are the
reference's: one plan names the same frame in either package.

Plan grammar (JSON, a list of fault specs, or ``@/path/to/plan.json``):

    [
      {"op": "drop",    "link": [0, 1], "seq": 2, "tag": "offsets"},
      {"op": "corrupt", "link": [1, 0], "seq": 1},
      {"op": "delay",   "link": [0, 1], "seq": 3, "delay_s": 0.2},
      {"op": "close",   "link": [0, 1], "seq": 4},
      {"op": "kill",    "link": [1, 0], "seq": 2, "exit_code": 137}
    ]

- ``op``: ``drop`` (the frame set is never sent), ``corrupt`` (a byte of
  the first frame is flipped on the wire after the CRC trailer is
  computed: the trailer catches it when ``PHOTON_P2P_CRC`` was negotiated),
  ``delay`` (``delay_s`` of sleep before the send), ``close`` (the link's
  socket is closed instead: the peer sees EOF), ``kill`` (the process
  exits at once with ``exit_code``, 137 by default: the peer-loss drill),
  ``rejoin`` (the process exits as ``kill`` does and re-execs ``delay_s``
  seconds later as a rejoin boot: the elastic-rejoin drill). ``rejoin``
  needs ``PHOTON_REJOIN_CMD``, a JSON argv list naming the command to
  relaunch (a ``python -c`` worker's command is not recoverable from
  ``sys.argv``); the child gets ``PHOTON_REJOIN_BOOT`` = the dying
  process's index and no fault plan (a rejoined process must not run the
  plan that killed it again), and inherits its standard output and error.
- ``link``: ``[src, dst]``, original process indices. A spec fires on the
  ``src`` process, at its framed send.
- ``seq``: the link's frame-set ordinal (the k-th frame set ever sent on
  that link since the mesh was last built: ``multihost._next_link_seq``).
- ``tag`` (optional): the exchange's tag must match too (``offsets``,
  ``scores``, ``re_combine/wv``, ...).

Every spec fires at most once, so a retried exchange's resend goes through
clean; two specs naming one frame set fire on successive attempts. The
plan is parsed once per distinct value of the knob, and with the knob
unset the send path pays one ``is None`` check.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

VALID_OPS = ("drop", "corrupt", "delay", "close", "kill", "rejoin")


@dataclass
class FaultSpec:
    op: str
    src: int
    dst: int
    seq: int
    tag: str | None = None
    delay_s: float = 0.0
    exit_code: int = 137
    fired: bool = False

    def matches(self, src: int, dst: int, seq: int, tag: str) -> bool:
        if self.fired:
            return False
        if (self.src, self.dst, self.seq) != (src, dst, seq):
            return False
        return self.tag is None or self.tag == tag


@dataclass
class FaultPlan:
    specs: list[FaultSpec] = field(default_factory=list)

    def pop_send_fault(self, src: int, dst: int, seq: int, tag: str) -> FaultSpec | None:
        """The first unfired spec for this frame set, consumed (a plan
        listing two specs for one frame set fires them on successive
        attempts: "fail twice, then succeed")."""
        for s in self.specs:
            if s.matches(src, dst, seq, tag):
                s.fired = True
                return s
        return None

    @property
    def remaining(self) -> int:
        return sum(1 for s in self.specs if not s.fired)


def parse_plan(text: str) -> FaultPlan:
    """Strict parse: a typo'd plan fails the run loudly instead of
    chaos-testing nothing."""
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    doc = json.loads(text)
    if not isinstance(doc, list):
        raise ValueError(f"PHOTON_FAULT_PLAN must be a JSON list of fault specs, got {type(doc).__name__}")
    specs: list[FaultSpec] = []
    for i, d in enumerate(doc):
        if not isinstance(d, dict):
            raise ValueError(f"fault spec {i} is not an object: {d!r}")
        unknown = set(d) - {"op", "link", "seq", "tag", "delay_s", "exit_code"}
        if unknown:
            raise ValueError(f"fault spec {i}: unknown keys {sorted(unknown)}")
        op = d.get("op")
        if op not in VALID_OPS:
            raise ValueError(f"fault spec {i}: op {op!r} not in {VALID_OPS}")
        link = d.get("link")
        if (not isinstance(link, (list, tuple)) or len(link) != 2
                or not all(isinstance(x, int) and x >= 0 for x in link)):
            raise ValueError(f"fault spec {i}: link must be [src, dst] process indices, got {link!r}")
        seq = d.get("seq")
        if not isinstance(seq, int) or seq < 1:
            raise ValueError(f"fault spec {i}: seq must be a 1-based frame-set ordinal, got {seq!r}")
        if op in ("delay", "rejoin") and not d.get("delay_s"):
            raise ValueError(f"fault spec {i}: {op} requires delay_s > 0")
        specs.append(FaultSpec(op=op, src=int(link[0]), dst=int(link[1]), seq=seq, tag=d.get("tag"),
                               delay_s=float(d.get("delay_s", 0.0)), exit_code=int(d.get("exit_code", 137))))
    return FaultPlan(specs=specs)


# parsed plans by the knob's raw value: the knob is read at call time
# without a parse per frame, and the fired state lives in the cached plan,
# so one process consumes its plan monotonically
_PLAN_CACHE: dict[str, FaultPlan] = {}


def active_plan() -> FaultPlan | None:
    """The process's fault plan, or None (the production path)."""
    env = os.environ.get("PHOTON_FAULT_PLAN")
    if not env:
        return None
    plan = _PLAN_CACHE.get(env)
    if plan is None:
        plan = _PLAN_CACHE[env] = parse_plan(env)
    return plan


def reset() -> None:
    """Forget parsed plans (tests re-arm consumed specs this way)."""
    _PLAN_CACHE.clear()


def _corrupt(buf: bytes) -> bytes:
    """One byte flipped mid-payload: the length framing cannot see it, the
    CRC trailer always does."""
    if not buf:
        return buf
    i = len(buf) // 2
    return buf[:i] + bytes([buf[i] ^ 0xFF]) + buf[i + 1:]


def apply_send_fault(spec: FaultSpec, frames: list, sock) -> tuple[list | None, bool]:
    """Apply ``spec`` at the framed send: returns ``(frames, corrupt_wire)``,
    the frame payloads to send (None: the whole frame set is dropped) and
    whether the link layer flips a byte of the first frame on the wire,
    after its CRC trailer is computed (a flip before the checksum would be
    checksummed faithfully and arrive "valid", testing nothing). ``close``
    and ``kill`` act on the socket and the process."""
    _emit(spec)
    if spec.op == "drop":
        return None, False
    if spec.op == "delay":
        time.sleep(spec.delay_s)
        return frames, False
    if spec.op == "corrupt":
        return frames, True
    if spec.op == "close":
        try:
            sock.close()
        # lint: waive(except-swallow) the close IS the injected fault; a double-close error is the drill succeeding
        except OSError:  # a second close: the fault has happened either way
            pass
        return frames, False  # the next send on the closed socket raises
    if spec.op == "kill":
        # a killed process is a killed process: no atexit, no finally, its
        # telemetry shard ends mid-run and its peers must cope
        os._exit(spec.exit_code)
    if spec.op == "rejoin":
        _spawn_rejoin_child(spec)
        os._exit(spec.exit_code)
    raise AssertionError(f"unhandled fault op {spec.op!r}")


def rejoin_command() -> list[str]:
    """``PHOTON_REJOIN_CMD``: the JSON argv list a ``rejoin`` spec
    relaunches (strict: anything else raises before the process dies)."""
    raw = os.environ.get("PHOTON_REJOIN_CMD")
    if not raw:
        raise RuntimeError("fault op 'rejoin' needs PHOTON_REJOIN_CMD (JSON argv list of the command to relaunch)")
    cmd = json.loads(raw)
    if not isinstance(cmd, list) or not cmd or not all(isinstance(c, str) for c in cmd):
        raise RuntimeError(f"PHOTON_REJOIN_CMD must be a JSON list of strings, got {raw!r}")
    return cmd


def _spawn_rejoin_child(spec: FaultSpec) -> None:
    """Start the delayed re-exec of a ``rejoin`` spec; the caller then
    exits. The child is a detached ``sh`` that sleeps ``delay_s`` and execs
    ``PHOTON_REJOIN_CMD`` with ``PHOTON_REJOIN_BOOT`` = this process's
    original index and the fault plan removed. Its standard output and
    error are this process's, so a harness reading the dying process's
    pipes reads the rejoiner's too."""
    import subprocess

    cmd = rejoin_command()
    env = dict(os.environ)
    env["PHOTON_REJOIN_BOOT"] = str(spec.src)
    env.pop("PHOTON_FAULT_PLAN", None)
    # "$0" "$@" carry the argv verbatim, and the exec makes the rejoiner the
    # shell's own process once this one has died
    subprocess.Popen(["/bin/sh", "-c", f'sleep {float(spec.delay_s)}; exec "$0" "$@"', *cmd], env=env,
                     start_new_session=True)


def _emit(spec: FaultSpec) -> None:
    """A ``fault_injected`` record (a ``kill``'s shard ends before it is
    flushed)."""
    from photon_ml_tpu_torch.obs.spans import emit_event

    emit_event("fault_injected", op=spec.op, src=spec.src, dst=spec.dst, seq=spec.seq, tag=spec.tag)


# -- the straggler (the re-planner's drill) ------------------------------------


def straggler_spec() -> tuple[int, float] | None:
    """``PHOTON_RE_STRAGGLER`` = ``"<process>:<delay_s>"``: the named
    process (its original index) sleeps ``delay_s`` at the start of every
    streamed random-effect bucket-solve visit, so its measured solve wall
    grows (the re-planner reads real timings) while the model stays
    bitwise the same. Strict parse."""
    env = os.environ.get("PHOTON_RE_STRAGGLER")
    if not env:
        return None
    proc, sep, delay = env.partition(":")
    if not sep:
        raise ValueError(f"PHOTON_RE_STRAGGLER must be '<process>:<delay_s>', got {env!r}")
    return int(proc), float(delay)


def maybe_straggle() -> float:
    """The straggler's sleep on the named process: the seconds slept (0.0
    elsewhere and with the knob unset, one read of the environment)."""
    spec = straggler_spec()
    if spec is None:
        return 0.0
    proc, delay = spec
    if delay <= 0.0:
        return 0.0
    from photon_ml_tpu_torch.parallel.multihost import original_process_index

    if original_process_index() != proc:
        return 0.0
    time.sleep(delay)
    from photon_ml_tpu_torch.obs.spans import emit_event

    emit_event("fault_injected", op="straggler", src=proc, dst=proc, seq=0, tag="re_solve", delay_s=delay)
    return delay
