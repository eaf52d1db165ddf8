"""The port's fault layer (``parallel/faults.py``, the framed mesh, the
degraded group and the descent's degrade in place) held against the JAX
package's on the CPU, in one process: fake sockets, socket pairs and
threads (the reference's ``tests/test_faults.py``, run on both packages).

- ``parse_plan`` on the reference's valid and invalid plans, spec for spec;
- the frame bytes, CRC on and off, the hello and the payload codec equal
  the reference's for the same payloads; the knob-off exchange wire;
- the send faults, the retry wrapper (the same calls, raises and counters)
  and the backoff schedule; send and receive heartbeats;
- ``_fragment_may_proceed`` over every partition of groups of 2-5, and the
  degraded rank mapping;
- a ring allgather over socket pairs in threads, with corrupt and delay
  specs; the healthy mesh's and gloo's hardening into ``PeerLost``;
- the strict parses of ``PHOTON_RE_STRAGGLER``, ``PHOTON_DESCENT_DEGRADE``,
  the rejoin knobs and ``PHOTON_COORD_MAX_MISSING_HEARTBEATS``;
- elastic rejoin: the ``rejoin`` op's re-exec, the mesh cache and the
  rejoin boot, the probe / invite / wait rendezvous over loopback, the
  quorum with rejoiners, and the streamed trainer's admission at a visit
  boundary (re-anchoring, a dropped survivor, a vanished rejoiner) and its
  rejoin guard, on the reference's cases;
- the descent's degrade in place on a fake random-effect coordinate
  (rollback, flap bound, mesh blockers), held to the reference's descent on
  the same fake; fingerprint collections and the metadata peek.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
import zlib
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch

import photon_ml_tpu.parallel.faults as jfaults
import photon_ml_tpu.parallel.multihost as jmh
import photon_ml_tpu_torch.parallel.faults as faults
import photon_ml_tpu_torch.parallel.multihost as mh


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


class FrameSock:
    """Replays pre-framed bytes on recv; records sends."""

    def __init__(self, frames=(), crc=False):
        self.buf = b"".join(struct.pack("!q", len(f)) + f + (struct.pack("!I", zlib.crc32(f)) if crc else b"")
                            for f in frames)
        self.sent: list[bytes] = []
        self.closed = False

    def recv(self, n):
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def sendall(self, data):
        if self.closed:
            raise OSError("socket closed")
        self.sent.append(bytes(data))

    def close(self):
        self.closed = True


def _wire(fn, *args, **kw) -> bytes:
    sock = FrameSock()
    fn(sock, *args, **kw)
    return b"".join(sock.sent)


# -- plans ------------------------------------------------------------------------

VALID_PLANS = [
    '[{"op": "drop", "link": [0, 1], "seq": 2, "tag": "offsets"},'
    ' {"op": "delay", "link": [1, 0], "seq": 1, "delay_s": 0.01}]',
    '[{"op": "kill", "link": [1, 0], "seq": 3, "tag": "offsets"}]',
    '[{"op": "corrupt", "link": [1, 0], "seq": 2, "tag": "scores"}, {"op": "close", "link": [0, 1], "seq": 4},'
    ' {"op": "kill", "link": [2, 0], "seq": 1, "exit_code": 9}]',
    '[{"op": "rejoin", "link": [3, 0], "seq": 5, "tag": "offsets", "delay_s": 2.0}]',
]
INVALID_PLANS = [
    '{"op": "drop"}',  # not a list
    '[{"op": "explode", "link": [0, 1], "seq": 1}]',  # bad op
    '[{"op": "drop", "link": [0], "seq": 1}]',  # bad link
    '[{"op": "drop", "link": [0, -1], "seq": 1}]',  # negative index
    '[{"op": "drop", "link": [0, 1], "seq": 0}]',  # bad seq
    '[{"op": "drop", "link": [0, 1], "seq": 1, "x": 1}]',  # unknown key
    '[{"op": "delay", "link": [0, 1], "seq": 1}]',  # no delay_s
    '[{"op": "rejoin", "link": [0, 1], "seq": 1}]',  # no delay_s
    '[3]',  # not an object
]


def _spec_fields(spec) -> tuple:
    return (spec.op, spec.src, spec.dst, spec.seq, spec.tag, spec.delay_s, spec.exit_code)


@pytest.mark.parametrize("text", VALID_PLANS)
def test_parse_plan_equals_the_reference(text):
    got, want = faults.parse_plan(text), jfaults.parse_plan(text)
    assert [_spec_fields(s) for s in got.specs] == [_spec_fields(s) for s in want.specs]
    assert got.remaining == want.remaining == len(want.specs)


@pytest.mark.parametrize("text", INVALID_PLANS)
def test_parse_plan_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        jfaults.parse_plan(text)
    with pytest.raises(ValueError):
        faults.parse_plan(text)


def test_plan_from_file_fires_once_and_matches_tag(tmp_path):
    p = tmp_path / "plan.json"
    p.write_text('[{"op": "drop", "link": [0, 1], "seq": 1, "tag": "offsets"},'
                 ' {"op": "drop", "link": [0, 1], "seq": 1, "tag": "offsets"}]')
    for mod in (faults, jfaults):
        plan = mod.parse_plan(f"@{p}")
        assert plan.pop_send_fault(0, 1, 1, "scores") is None
        assert plan.pop_send_fault(0, 2, 1, "offsets") is None
        # two specs for one frame set fire on successive attempts, then none
        assert plan.pop_send_fault(0, 1, 1, "offsets") is not None
        assert plan.pop_send_fault(0, 1, 1, "offsets") is not None
        assert plan.pop_send_fault(0, 1, 1, "offsets") is None
        assert plan.remaining == 0


def test_active_plan_caches_and_no_plan_is_none(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULT_PLAN", raising=False)
    assert faults.active_plan() is None
    monkeypatch.setenv("PHOTON_FAULT_PLAN", '[{"op": "drop", "link": [0, 1], "seq": 1}]')
    plan = faults.active_plan()
    assert plan is not None and faults.active_plan() is plan  # the fired state sticks
    monkeypatch.setenv("PHOTON_FAULT_PLAN", '{"op": "x"}')
    with pytest.raises(ValueError):
        faults.active_plan()


def test_rejoin_knobs_and_op_parse_strictly_as_the_reference(monkeypatch):
    """``PHOTON_REJOIN``, ``PHOTON_REJOIN_WINDOW_S`` and the ``rejoin`` op's
    ``PHOTON_REJOIN_CMD`` read as the reference reads them: a typo raises,
    nothing is refused."""
    for v in ("0", "1", "2", ""):
        monkeypatch.setenv("PHOTON_REJOIN", v)
        assert mh.rejoin_enabled() == jmh.rejoin_enabled()
    monkeypatch.delenv("PHOTON_REJOIN")
    assert mh.rejoin_enabled() is jmh.rejoin_enabled() is False
    monkeypatch.setenv("PHOTON_REJOIN", "zz")
    for mod in (mh, jmh):
        with pytest.raises(ValueError):
            mod.rejoin_enabled()
    monkeypatch.delenv("PHOTON_REJOIN_WINDOW_S", raising=False)
    assert mh.rejoin_window_s() == jmh.rejoin_window_s() == 10.0
    for v in ("2.5", "0", "-3"):
        monkeypatch.setenv("PHOTON_REJOIN_WINDOW_S", v)
        assert mh.rejoin_window_s() == jmh.rejoin_window_s()
    monkeypatch.setenv("PHOTON_REJOIN_WINDOW_S", "soon")
    for mod in (mh, jmh):
        with pytest.raises(ValueError):
            mod.rejoin_window_s()
    monkeypatch.delenv("PHOTON_REJOIN_CMD", raising=False)
    with pytest.raises(RuntimeError, match="PHOTON_REJOIN_CMD"):
        faults.rejoin_command()
    for bad in ('"python"', '[1, 2]', "[]"):
        monkeypatch.setenv("PHOTON_REJOIN_CMD", bad)
        with pytest.raises(RuntimeError, match="JSON list of strings"):
            faults.rejoin_command()
    monkeypatch.setenv("PHOTON_REJOIN_CMD", '["python", "-c", "pass"]')
    assert faults.rejoin_command() == ["python", "-c", "pass"]


# -- frames and payloads ---------------------------------------------------------

PAYLOADS = [b"", b"abcdef", np.arange(7, dtype=np.float32).tobytes(), bytes(range(256)) * 9]


@pytest.mark.parametrize("crc", [False, True])
@pytest.mark.parametrize("payload", PAYLOADS, ids=lambda p: f"{len(p)}B")
def test_frame_bytes_equal_the_reference(payload, crc):
    got = _wire(mh._send_frame, payload, crc)
    assert got == _wire(jmh._send_frame, payload, crc)
    assert got == struct.pack("!q", len(payload)) + payload + (struct.pack("!I", zlib.crc32(payload)) if crc else b"")
    # and it reads back (CRC checked on a CRC link)
    echo = FrameSock([payload], crc=crc)
    n = struct.unpack("!q", mh._recv_exact(echo, 8))[0]
    assert mh._recv_frame_payload(echo, n, crc) == payload


Pair = namedtuple("Pair", "a b")
OBJECTS = [
    "x",
    {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": 3},
    (np.int64(5), np.zeros(0, np.int32), [np.array(2.5), "t"]),
    Pair(np.ones((2, 2), np.float64), np.array([1, 2], np.int16)),
    [np.frombuffer(b"\x01\x02\x03", np.uint8), np.array(["a", "b"], dtype=object)],
    np.arange(12, dtype=np.int64),
]


@pytest.mark.parametrize("crc", [False, True])
@pytest.mark.parametrize("obj", OBJECTS, ids=[f"obj{i}" for i in range(len(OBJECTS))])
def test_payload_codec_and_multi_part_frames_equal_the_reference(obj, crc):
    parts, total = mh._encode_host_payload(obj)
    jparts, jtotal = jmh._encode_host_payload(obj)
    assert total == jtotal and [bytes(p) for p in parts] == [bytes(p) for p in jparts]
    got = _wire(mh._send_frame_parts, parts, total, crc)
    assert got == _wire(jmh._send_frame_parts, jparts, jtotal, crc)
    back = mh._decode_host_payload(got[8:8 + total])
    want = jmh._decode_host_payload(got[8:8 + total])
    assert type(back) is type(want)
    flat_b, flat_w = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)
    assert len(flat_b) == len(flat_w)
    for b, w in zip(flat_b, flat_w):
        if isinstance(w, np.ndarray):
            assert b.dtype == w.dtype and b.shape == w.shape and b.tobytes() == w.tobytes() and b.flags.writeable
        else:
            assert b == w


def test_corruption_is_a_wire_fault_the_crc_catches():
    payload = b"x" * 64
    assert faults._corrupt(payload) == jfaults._corrupt(payload) != payload
    got = _wire(mh._send_frame, payload, True, corrupt_wire=True)
    assert got == _wire(jmh._send_frame, payload, True, corrupt_wire=True)
    assert struct.unpack("!I", got[-4:])[0] == zlib.crc32(payload)  # the trailer of the good bytes
    wire = FrameSock()
    wire.buf = got
    n = struct.unpack("!q", mh._recv_exact(wire, 8))[0]
    with pytest.raises(mh.LinkCorruption):
        mh._recv_frame_payload(wire, n, True)


def test_hello_equals_the_reference(monkeypatch):
    monkeypatch.delenv("PHOTON_P2P_CRC", raising=False)
    assert mh._hello_int(3) == jmh._hello_int(3) == 3  # knob off: the pid verbatim
    monkeypatch.setenv("PHOTON_P2P_CRC", "1")
    raw = mh._hello_int(3)
    assert raw == jmh._hello_int(3)
    assert mh._decode_hello(raw) == jmh._decode_hello(raw) == (3, mh._FRAME_PROTO_CRC)
    monkeypatch.setenv("PHOTON_P2P_CRC", "x")
    with pytest.raises(ValueError):
        mh._p2p_crc_enabled()


def _two_process_fakes(monkeypatch, links):
    monkeypatch.setattr(mh, "_HOST_LINKS", links)
    monkeypatch.setattr(mh, "_host_links", lambda: links)
    monkeypatch.setattr(mh, "_world_size", lambda: 2)
    monkeypatch.setattr(mh, "_self_pid", lambda: 0)
    monkeypatch.setattr(mh, "_LINK_SEQ", {"send": {}, "recv": {}})


def test_knob_off_exchange_wire_equals_the_reference(monkeypatch):
    """No plan and every knob unset: the framed exchange puts the plain
    frames on the wire (no CRC trailer, no completion ACK), the bytes the
    reference's exchange puts there for the same rows."""
    for k in ("PHOTON_P2P_CRC", "PHOTON_P2P_RETRIES", "PHOTON_FAULT_PLAN", "PHOTON_P2P_HEARTBEAT_S"):
        monkeypatch.delenv(k, raising=False)
    arrays = {"v": np.arange(4, dtype=np.float32), "g": np.arange(4, dtype=np.int64) * 3}
    order, starts = np.arange(4, dtype=np.int64), np.asarray([0, 2, 4], np.int64)
    incoming = [np.arange(2, dtype=np.int64).tobytes(), np.arange(2, dtype=np.float32).tobytes()]
    links = {"send": {1: FrameSock()}, "recv": {1: FrameSock(incoming)}}
    jlinks = {"send": {1: FrameSock()}, "recv": {1: FrameSock(incoming)}}
    _two_process_fakes(monkeypatch, links)
    monkeypatch.setattr(jmh, "_HOST_LINKS", jlinks)
    monkeypatch.setattr(jmh, "_host_links", lambda: jlinks)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    monkeypatch.setattr(jmh, "_LINK_SEQ", {"send": {}, "recv": {}})
    out = mh._host_p2p_exchange(arrays, order, starts, None, tag="t")
    want = jmh._host_p2p_exchange(arrays, order, starts, None, tag="t")
    assert b"".join(links["send"][1].sent) == b"".join(jlinks["send"][1].sent)
    assert b"".join(links["send"][1].sent) == b"".join(
        struct.pack("!q", len(b)) + b for b in (arrays["g"][2:].tobytes(), arrays["v"][2:].tobytes()))
    assert links["recv"][1].buf == b""  # drained exactly: no ACK read
    for k in arrays:
        assert out[k].tobytes() == want[k].tobytes()
    assert mh._LINK_SEQ == {"send": {1: 1}, "recv": {1: 1}}


# -- send faults, retries, backoff, heartbeats ---------------------------------------


@pytest.mark.parametrize("op", ["drop", "corrupt", "close", "delay"])
def test_send_faults_equal_the_reference(op):
    out = []
    for mod in (faults, jfaults):
        spec = mod.FaultSpec(op=op, src=0, dst=1, seq=1, delay_s=0.05)
        sock = FrameSock()
        t0 = time.perf_counter()
        bufs, corrupt = mod.apply_send_fault(spec, [b"aaaa", b"bbbb"], sock)
        out.append((bufs, corrupt, sock.closed, time.perf_counter() - t0 >= 0.04))
    assert out[0] == out[1]
    if op == "close":
        assert out[0][2]


def _retry_call(monkeypatch, mod, attempts_needed, error, retries):
    calls = {"n": 0}

    def impl(*a, **k):
        calls["n"] += 1
        if calls["n"] <= attempts_needed:
            raise error
        return {"ok": calls["n"]}

    monkeypatch.setattr(mod, "_host_p2p_exchange_impl", impl)
    monkeypatch.setattr(mod, "_reset_host_links", lambda: None)
    monkeypatch.setenv("PHOTON_P2P_RETRIES", str(retries))
    monkeypatch.setenv("PHOTON_P2P_BACKOFF_S", "0")

    def run():
        try:
            return ("ok", mod._host_p2p_exchange({}, np.zeros(0, np.int64), np.zeros(1, np.int64), tag="t"))
        except Exception as e:  # the outcome is compared across packages
            return (type(e).__name__, getattr(e, "peer", None))

    return calls, run


RETRY_CASES = {
    "transient_then_success": (2, lambda m: ConnectionError("reset"), 3),
    "knob_off_raises_at_once": (1, lambda m: ConnectionError("reset"), 0),
    "exhaustion_raises_the_error": (10, lambda m: socket.timeout("silent"), 2),
    "unreachable_hardens_into_peer_lost": (10, lambda m: m.PeerUnreachable(1, "refused"), 2),
    "non_transient_never_retried": (10, lambda m: RuntimeError("size mismatch"), 5),
    "corruption_is_transient": (1, lambda m: m.LinkCorruption("crc"), 1),
}


@pytest.mark.parametrize("case", list(RETRY_CASES))
def test_retry_wrapper_equals_the_reference(monkeypatch, case):
    from photon_ml_tpu.obs.metrics import REGISTRY as JREG
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    need, err, retries = RETRY_CASES[case]
    outcomes = []
    for mod, reg in ((mh, REGISTRY), (jmh, JREG)):
        reg.reset("p2p.")
        calls, run = _retry_call(monkeypatch, mod, need, err(mod), retries)
        res = run()
        counters = {k: v["value"] for k, v in reg.snapshot("p2p.")["counters"].items()}
        outcomes.append((res, calls["n"], counters))
    assert outcomes[0] == outcomes[1]


def test_retry_records_ride_the_sink(tmp_path, monkeypatch):
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.report import load_run

    path = obs.configure(str(tmp_path / "tel"), run_id="retry")
    try:
        _, run = _retry_call(monkeypatch, mh, 1, mh.LinkCorruption("crc"), 1)
        assert run()[0] == "ok"
        _, run2 = _retry_call(monkeypatch, mh, 10, mh.PeerUnreachable(1, "x"), 1)
        assert run2() == ("PeerLost", 1)
    finally:
        obs.shutdown()
    records = load_run(path)
    retries = [r for r in records if r["event"] == "p2p_retry"]
    giveups = [r for r in records if r["event"] == "p2p_giveup"]
    assert len(retries) == 2 and len(giveups) == 1
    assert (retries[0]["error"], retries[0]["tag"], retries[0]["attempt"]) == ("LinkCorruption", "t", 1)
    assert (giveups[0]["error"], giveups[0]["peer"]) == ("PeerUnreachable", 1)


@pytest.mark.parametrize("base", ["0.25", "0.5", "0"])
def test_backoff_schedule_equals_the_reference(monkeypatch, base):
    monkeypatch.setenv("PHOTON_P2P_BACKOFF_S", base)
    monkeypatch.setattr(mh, "_self_pid", lambda: 0)
    got = [mh._retry_backoff_sleep(k) for k in range(6)]
    assert got == [jmh._retry_backoff_sleep(k) for k in range(6)]
    if float(base):
        assert float(base) <= got[0] < 1.5 * float(base) and got[1] >= 2 * float(base)
    for pid in (1, 3, 7):  # the per-process jitter, with jax's index set alike
        monkeypatch.setattr(mh, "_self_pid", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        assert [mh._retry_backoff_sleep(k) for k in range(4)] == [jmh._retry_backoff_sleep(k) for k in range(4)]


@pytest.mark.parametrize("name,values", [
    ("PHOTON_P2P_TIMEOUT_S", ["", "3", "0", "-1", "2.5"]),
    ("PHOTON_P2P_RETRIES", ["", "0", "4", "-2"]),
    ("PHOTON_P2P_BACKOFF_S", ["", "0.1", "-1"]),
    ("PHOTON_P2P_HEARTBEAT_S", ["", "0", "0.2"]),
    ("PHOTON_P2P_CRC", ["", "0", "1"]),
])
def test_knob_readers_equal_the_reference(monkeypatch, name, values):
    reader = {"PHOTON_P2P_TIMEOUT_S": "_p2p_timeout_s", "PHOTON_P2P_RETRIES": "_p2p_retries",
              "PHOTON_P2P_BACKOFF_S": "_p2p_backoff_s", "PHOTON_P2P_HEARTBEAT_S": "_p2p_heartbeat_s",
              "PHOTON_P2P_CRC": "_p2p_crc_enabled"}[name]
    for v in values:
        monkeypatch.setenv(name, v)
        assert getattr(mh, reader)() == getattr(jmh, reader)()
    monkeypatch.setenv(name, "abc")  # strict: a typo raises in both
    with pytest.raises(ValueError):
        getattr(jmh, reader)()
    with pytest.raises(ValueError):
        getattr(mh, reader)()


def test_send_heartbeats(tmp_path, monkeypatch):
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.report import load_run

    sock = FrameSock()
    mh._sendall_hb(sock, b"abc")
    assert sock.sent == [b"abc"]  # the plain path is sendall
    monkeypatch.setenv("PHOTON_P2P_TIMEOUT_S", "0.25")
    path = obs.configure(str(tmp_path / "tel"), run_id="hb")
    a, b = socket.socketpair()
    try:
        a.setblocking(False)
        try:
            while True:
                a.send(b"x" * 65536)
        except BlockingIOError:
            pass
        a.setblocking(True)
        with pytest.raises((socket.timeout, TimeoutError)):
            mh._sendall_hb(a, b"y" * (1 << 22), peer=1, tag="scores", heartbeat=0.05)
    finally:
        obs.shutdown()
        a.close()
        b.close()
    beats = [r for r in load_run(path) if r["event"] == "p2p_heartbeat"]
    assert len(beats) >= 2
    assert all(r["direction"] == "send" and r["peer"] == 1 and r["tag"] == "scores" for r in beats)
    assert beats[-1]["blocked_s"] >= beats[0]["blocked_s"]


def test_receive_heartbeats_without_a_timeout(tmp_path, monkeypatch):
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.report import load_run

    monkeypatch.setenv("PHOTON_P2P_TIMEOUT_S", "0")
    path = obs.configure(str(tmp_path / "tel"), run_id="hb0")
    a, b = socket.socketpair()
    t = threading.Thread(target=lambda: (time.sleep(0.3), b.sendall(b"z" * 8)))
    t.start()
    try:
        assert mh._recv_exact(a, 8, peer=1, tag="offsets", heartbeat=0.05) == b"z" * 8
    finally:
        t.join()
        obs.shutdown()
        a.close()
        b.close()
    beats = [r for r in load_run(path) if r["event"] == "p2p_heartbeat"]
    assert len(beats) >= 2 and all(r["direction"] == "recv" for r in beats)


def test_drain_records_a_worker_failure_and_reset_forgets(tmp_path):
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.report import load_run

    def boom():
        raise mh.PeerUnreachable(1, "refused")

    path = obs.configure(str(tmp_path / "tel"), run_id="drain")
    try:
        fut = mh._exchange_pool().submit(boom)
        with mh._EXCHANGE_LOCK:
            mh._PENDING_EXCHANGES.append((fut, "offsets"))
        mh.drain_async_exchanges()
        mh.drain_async_exchanges()  # dropped on first sight: reported once
    finally:
        obs.shutdown()
        mh.reset_async_exchanges()
    errs = [r for r in load_run(path) if r["event"] == "exchange_drain_error"]
    assert [(r["tag"], r["error"], r["peer"]) for r in errs] == [("offsets", "PeerUnreachable", 1)]
    fut = mh._exchange_pool().submit(lambda: None)
    with mh._EXCHANGE_LOCK:
        mh._PENDING_EXCHANGES.append((fut, "t"))
    mh.reset_async_exchanges()
    assert not mh._PENDING_EXCHANGES


# -- the quorum and the degraded group ----------------------------------------------


@pytest.mark.parametrize("size", [2, 3, 4, 5])
def test_fragment_quorum_equals_the_reference_over_every_partition(size):
    group = list(range(size))
    for r in range(size + 1):
        for frag in itertools.combinations(group, r):
            other = [p for p in group if p not in frag]
            got = mh._fragment_may_proceed(list(frag), group)
            assert got == jmh._fragment_may_proceed(list(frag), group), frag
            # at most one side of any partition proceeds
            assert not (got and mh._fragment_may_proceed(other, group)), (frag, other)
            # a non-member never pads the count
            assert mh._fragment_may_proceed(list(frag) + [99], group) == got
    assert mh._fragment_may_proceed([0], [0, 1]) and not mh._fragment_may_proceed([1], [0, 1])


class TestDegradedGroup:
    @pytest.fixture(autouse=True)
    def _restore(self):
        yield
        mh._DEGRADED = None
        jmh._DEGRADED = None

    def test_single_survivor_world(self, monkeypatch):
        monkeypatch.setattr(mh, "_DEGRADED", {"survivors": (0,), "rank": 0})
        assert mh.process_count() == mh.effective_process_count() == 1
        assert mh.process_index() == 0 and mh.is_output_process()
        # every collective is the identity: nothing touches gloo
        mh.sync_processes("after-loss")
        assert mh.allreduce_sum_host(np.asarray([3.0])) == [3.0]
        out = mh.exchange_rows({"v": np.arange(3.0)}, np.zeros(3, np.int64))
        np.testing.assert_array_equal(out["v"], np.arange(3.0))
        assert mh.LAST_EXCHANGE_STATS["transport"] == "local"
        np.testing.assert_array_equal(mh.broadcast_from_host0({"a": np.ones(2)})["a"], np.ones(2))
        assert mh.allgather_obj_p2p("x") == ["x"]
        assert mh.effective_topology()[2] == 1

    @pytest.mark.parametrize("survivors,pid", [((0, 2, 3), 2), ((1, 3), 3), ((0, 1, 2, 4), 4), ((2,), 2)])
    def test_rank_mapping_equals_the_reference(self, monkeypatch, survivors, pid):
        monkeypatch.setattr(mh, "_self_pid", lambda: pid)
        monkeypatch.setattr(mh, "_world_size", lambda: 5)
        monkeypatch.setattr(mh, "_reset_host_links", lambda: None)
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        monkeypatch.setattr(jax, "process_count", lambda: 5)
        monkeypatch.setattr(jmh, "_reset_host_links", lambda: None)
        mh.set_degraded_group(survivors)
        jmh.set_degraded_group(survivors)
        assert mh.degraded_group() == jmh.degraded_group()
        assert (mh.process_count(), mh.process_index()) == (jmh.effective_process_count(),
                                                            jmh.effective_process_index())
        assert [mh._orig_pid(r) for r in range(len(survivors))] == [jmh._orig_pid(r) for r in range(len(survivors))]
        assert mh.is_output_process() == jmh.is_output_process() == (pid == min(survivors))
        assert mh.original_process_index() == pid and mh.original_process_count() == 5

    def test_set_degraded_group_requires_membership(self, monkeypatch):
        monkeypatch.setattr(mh, "_self_pid", lambda: 0)
        with pytest.raises(ValueError):
            mh.set_degraded_group([1, 2])

    def test_whole_group_is_not_degraded(self, monkeypatch):
        monkeypatch.setattr(mh, "_self_pid", lambda: 1)
        monkeypatch.setattr(mh, "_world_size", lambda: 2)
        mh.set_degraded_group([0, 1])
        assert mh.degraded_group() is None


def test_partial_mesh_build_closes_everything(monkeypatch):
    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    port = free_port()
    monkeypatch.setattr(mh, "_self_pid", lambda: 0)
    monkeypatch.setattr(mh, "_world_size", lambda: 3)
    monkeypatch.setattr(mh, "_HOST_ADDRS", {0: ("127.0.0.1", port), 1: ("127.0.0.1", free_port()),
                                            2: ("127.0.0.1", free_port())})
    monkeypatch.setattr(mh, "_HOST_LINKS", None)
    before = {t.ident for t in threading.enumerate() if t.is_alive()}
    for _ in range(2):  # two failed builds in a row: nothing leaks
        with pytest.raises(mh.PeerUnreachable) as ei:
            mh._build_host_links([0, 1, 2], timeout_s=0.3)
        assert ei.value.peer in (1, 2)
    assert not [t for t in threading.enumerate() if t.is_alive() and t.ident not in before]
    with socket.socket() as s:  # the recorded port binds at once: the listener closed
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


def test_mesh_listener_admits_only_a_build_peer_from_its_published_address(monkeypatch):
    """The listener binds the address it publishes (loopback here, not
    every interface), and a connection from another address, or one whose
    hello names no peer of the build, is closed unread; the peer's own
    connection is then admitted."""
    peer_srv = socket.socket()
    peer_srv.bind(("127.0.0.2", 0))
    peer_srv.listen(4)
    published = {}
    ready = threading.Event()

    def gather(own):
        published[0] = tuple(own)
        ready.set()
        return {0: tuple(own), 1: peer_srv.getsockname()}

    monkeypatch.setattr(mh, "_self_pid", lambda: 0)
    monkeypatch.setattr(mh, "_world_size", lambda: 2)
    monkeypatch.setattr(mh, "_local_ip", lambda: "127.0.0.1")
    monkeypatch.setattr(mh, "_gather_link_addrs", gather)
    monkeypatch.setattr(mh, "_HOST_ADDRS", None)
    monkeypatch.delenv("PHOTON_P2P_CRC", raising=False)
    out, errs = {}, []

    def build():
        try:
            out["links"] = mh._build_host_links([0, 1], timeout_s=5)
        except BaseException as e:
            errs.append(e)

    t = threading.Thread(target=build)
    t.start()
    try:
        assert ready.wait(5)
        host, port = published[0]
        assert host == "127.0.0.1"
        with pytest.raises(OSError):  # not listening on every interface
            socket.create_connection(("127.0.0.5", port), timeout=1).close()
        dialed, _ = peer_srv.accept()  # process 0's link to process 1
        strangers = []
        for src_ip, hello_pid in (("127.0.0.3", 1), ("127.0.0.2", 7)):
            s = socket.socket()
            s.bind((src_ip, 0))
            s.connect((host, port))
            s.sendall(struct.pack("!i", mh._hello_int(hello_pid)))
            strangers.append(s)
        for s in strangers:  # closed by the listener (a reset where the hello went unread)
            s.settimeout(5)
            try:
                assert s.recv(1) == b""
            except ConnectionResetError:
                pass
            s.close()
        real = socket.socket()
        real.bind(("127.0.0.2", 0))
        real.connect((host, port))
        real.sendall(struct.pack("!i", mh._hello_int(1)))
        t.join(10)
        assert not errs and not t.is_alive()
        links = out["links"]
        assert set(links["recv"]) == {1} and links["recv"][1].getpeername() == real.getsockname()
        for sock in (*links["send"].values(), *links["recv"].values(), dialed, real):
            sock.close()
    finally:
        peer_srv.close()
        t.join(10)


# -- the ring ---------------------------------------------------------------------


def _pair_links(crc):
    a01, b01 = socket.socketpair()
    a10, b10 = socket.socketpair()
    proto = {"proto": {0: 1, 1: 1}} if crc else {"proto": {}}
    return ({"send": {1: a01}, "recv": {1: b10}, **proto}, {"send": {0: a10}, "recv": {0: b01}, **proto},
            (a01, b01, a10, b10))


def _ring_pair(monkeypatch, plan, crc, objs):
    monkeypatch.setitem(mh._LINK_SEQ, "send", {})
    monkeypatch.setitem(mh._LINK_SEQ, "recv", {})
    if plan is None:
        monkeypatch.delenv("PHOTON_FAULT_PLAN", raising=False)
    else:
        monkeypatch.setenv("PHOTON_FAULT_PLAN", plan)
    faults.reset()
    links0, links1, socks = _pair_links(crc)
    out, errs = {}, {}

    def run(rank, links):
        try:
            out[rank] = mh._ring_allgather(links, [0, 1], rank, objs[rank], "ring", None)
        except BaseException as e:
            errs[rank] = e

    t = threading.Thread(target=run, args=(1, links1))
    t.start()
    run(0, links0)
    t.join()
    for s in socks:
        s.close()
    return out, errs


def test_ring_allgather_delivers_every_rank_s_object(monkeypatch):
    objs = {0: {"w": np.ones(4, np.float32)}, 1: ("t", np.arange(3))}
    out, errs = _ring_pair(monkeypatch, None, True, objs)
    assert not errs
    for r in (0, 1):
        assert out[r][0]["w"].tobytes() == objs[0]["w"].tobytes()
        assert out[r][1][0] == "t" and out[r][1][1].tobytes() == objs[1][1].tobytes()


def test_ring_corrupt_spec_is_detected_by_the_crc(monkeypatch):
    out, errs = _ring_pair(monkeypatch, '[{"op": "corrupt", "link": [0, 1], "seq": 1, "tag": "ring"}]', True,
                           {0: {"w": np.ones(4, np.float32)}, 1: {"w": np.arange(4, dtype=np.float32)}})
    assert isinstance(errs.get(1), mh.LinkCorruption), errs
    assert getattr(errs[1], "peer", None) == 0  # the receive error names the link
    assert faults.active_plan().remaining == 0


def test_ring_delay_spec_passes_the_payload_through(monkeypatch):
    t0 = time.perf_counter()
    out, errs = _ring_pair(monkeypatch, '[{"op": "delay", "link": [0, 1], "seq": 1, "delay_s": 0.05}]', False,
                           {0: {"w": np.ones(2)}, 1: {"w": np.arange(2.0)}})
    assert not errs and time.perf_counter() - t0 >= 0.05
    np.testing.assert_array_equal(out[1][0]["w"], np.ones(2))
    assert faults.active_plan().remaining == 0
    assert mh._LINK_SEQ["send"] == {1: 1, 0: 1} or mh._LINK_SEQ["recv"]


@pytest.mark.parametrize("retries", [None, "2"])
def test_healthy_mesh_and_gloo_harden_into_peer_lost_only_when_armed(monkeypatch, retries):
    monkeypatch.setattr(mh, "_DEGRADED", None)
    monkeypatch.setattr(mh, "_world_size", lambda: 2)
    monkeypatch.setattr(mh, "_self_pid", lambda: 0)
    if retries is None:
        monkeypatch.delenv("PHOTON_P2P_RETRIES", raising=False)
    else:
        monkeypatch.setenv("PHOTON_P2P_RETRIES", retries)

    def boom():
        e = ConnectionError("link down")
        e.peer = 1
        raise e

    def gloo_boom():
        raise RuntimeError("Connection closed by peer")

    monkeypatch.setattr(mh, "_host_links", boom)
    if retries is None:
        with pytest.raises(ConnectionError) as ei:
            mh._p2p_allgather_obj("x", tag="combine")
        assert not isinstance(ei.value, mh.PeerLost)
        with pytest.raises(RuntimeError):
            mh._gloo(gloo_boom, "allgather_host")
    else:
        with pytest.raises(mh.PeerLost) as ei:
            mh._p2p_allgather_obj("x", tag="combine")
        assert ei.value.peer == 1
        with pytest.raises(mh.PeerLost) as ei:
            mh._gloo(gloo_boom, "allgather_host")
        assert ei.value.peer == -1
        with pytest.raises(mh.PeerLost):  # the calling thread's mesh build too
            mh._links_in_program_order("offsets")


# -- knobs of the trainers ------------------------------------------------------------


def test_straggler_and_descent_degrade_parse_strictly(monkeypatch):
    from photon_ml_tpu.game import descent as jdescent
    from photon_ml_tpu_torch.game import descent

    monkeypatch.delenv("PHOTON_RE_STRAGGLER", raising=False)
    assert faults.straggler_spec() is None and faults.maybe_straggle() == 0.0
    for v in ("1:0.5", "0:0", "3:2.25"):
        monkeypatch.setenv("PHOTON_RE_STRAGGLER", v)
        assert faults.straggler_spec() == jfaults.straggler_spec()
    for bad in ("1", "x:1", "1:y"):
        monkeypatch.setenv("PHOTON_RE_STRAGGLER", bad)
        with pytest.raises(ValueError):
            jfaults.straggler_spec()
        with pytest.raises(ValueError):
            faults.straggler_spec()
    monkeypatch.setenv("PHOTON_RE_STRAGGLER", "1:5")  # another process: no sleep
    t0 = time.perf_counter()
    assert faults.maybe_straggle() == 0.0 and time.perf_counter() - t0 < 1.0
    monkeypatch.setenv("PHOTON_RE_STRAGGLER", "0:0.05")
    assert faults.maybe_straggle() == 0.05
    monkeypatch.delenv("PHOTON_DESCENT_DEGRADE", raising=False)
    assert not descent.descent_degrade_enabled()
    for v in ("0", "1", "2"):
        monkeypatch.setenv("PHOTON_DESCENT_DEGRADE", v)
        assert descent.descent_degrade_enabled() == jdescent.descent_degrade_enabled()
    monkeypatch.setenv("PHOTON_DESCENT_DEGRADE", "yes")
    with pytest.raises(ValueError):
        descent.descent_degrade_enabled()


# -- the descent's degrade in place ------------------------------------------------------


class _FakeReCoord:
    """A deterministic coordinate (the coefficients a pure function of the
    offsets) with real random-effect models, raising the package's
    ``PeerLost`` at the n-th train call."""

    coordinate_id = "c"

    def __init__(self, port: bool, fail_at_call=None, fail_always=False):
        self.port, self.calls = port, 0
        self.fail_at_call, self.fail_always = fail_at_call, fail_always

    def train(self, offsets, initial=None):
        self.calls += 1
        if self.fail_always or (self.fail_at_call is not None and self.calls == self.fail_at_call):
            if not self.fail_always:
                self.fail_at_call = None
            raise (mh if self.port else jmh).PeerLost(1, "injected descent loss")
        if self.port:
            from photon_ml_tpu_torch.game.models import RandomEffectModel
            from photon_ml_tpu_torch.types import TaskType

            w = torch.mean(offsets) * 0.5 + 1.0
            coef = torch.full((2, 3), float(w))
        else:
            import jax.numpy as jnp

            from photon_ml_tpu.game.models import RandomEffectModel
            from photon_ml_tpu.types import TaskType

            w = jnp.mean(offsets) * 0.5 + 1.0
            coef = jnp.full((2, 3), w, jnp.float32)
        sub = RandomEffectModel(coefficients=coef, variances=None, random_effect_type="eid",
                                feature_shard_id="r", task_type=TaskType.LOGISTIC_REGRESSION)
        return sub, {"call": self.calls}

    def score(self, sub):
        if self.port:
            return torch.full((4,), float(torch.mean(sub.coefficients)))
        import jax.numpy as jnp

        return jnp.full((4,), jnp.mean(sub.coefficients), jnp.float32)


def _tiny_descent(coord):
    if coord.port:
        from photon_ml_tpu_torch.game.data import GameBatch
        from photon_ml_tpu_torch.game.descent import CoordinateDescent
        from photon_ml_tpu_torch.types import TaskType

        z = torch.zeros(4)
        batch = GameBatch(labels=z, offsets=z, weights=torch.ones(4), features={}, id_tags={})
    else:
        import jax.numpy as jnp

        from photon_ml_tpu.game.data import GameBatch
        from photon_ml_tpu.game.descent import CoordinateDescent
        from photon_ml_tpu.types import TaskType

        z = jnp.zeros(4, jnp.float32)
        batch = GameBatch(labels=z, offsets=z, weights=jnp.ones(4, jnp.float32), features={}, id_tags={})
    return CoordinateDescent(coordinates={"c": coord}, batch=batch, task_type=TaskType.LOGISTIC_REGRESSION)


def _arm(monkeypatch, survivors, world=2):
    calls = {"degraded": [], "reset": 0}
    for mod in (mh, jmh):
        monkeypatch.setattr(mod, "roll_call", lambda **kw: list(survivors))
        monkeypatch.setattr(mod, "original_process_count", lambda: world)
        monkeypatch.setattr(mod, "degraded_group", lambda: None)
        monkeypatch.setattr(mod, "set_degraded_group", lambda s: calls["degraded"].append(list(s)))
        monkeypatch.setattr(mod, "reset_async_exchanges", lambda: None)
    return calls


def _both(fn):
    """``fn(port)`` on the port and on the reference: (outcome, calls) each,
    an outcome the result or the error's type and message start."""
    out = []
    for port in (True, False):
        try:
            out.append(("ok", fn(port)))
        except Exception as e:  # the outcome is compared across packages
            out.append((type(e).__name__, str(e).split(" — ")[0]))
    return out


def test_descent_knob_off_keeps_the_abort(monkeypatch):
    monkeypatch.delenv("PHOTON_DESCENT_DEGRADE", raising=False)
    port, ref = _both(lambda p: _tiny_descent(_FakeReCoord(p, fail_at_call=2)).run(["c"], 3))
    assert port == ref and port[0] == "RuntimeError" and "cannot degrade in place" in port[1]


def test_descent_degrades_in_place_as_the_reference(monkeypatch):
    monkeypatch.setenv("PHOTON_DESCENT_DEGRADE", "1")
    calls = _arm(monkeypatch, survivors=[0])
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.reset("fleet.")
    clean = _tiny_descent(_FakeReCoord(True)).run(["c"], 3)
    coord = _FakeReCoord(True, fail_at_call=2)
    res = _tiny_descent(coord).run(["c"], 3)
    jcoord = _FakeReCoord(False, fail_at_call=2)
    jres = _tiny_descent(jcoord).run(["c"], 3)
    assert calls["degraded"] == [[0], [0]]
    assert coord.calls == jcoord.calls == 4  # 3 iterations and the rolled-back one
    assert res.model.models["c"].coefficients.numpy().tobytes() == clean.model.models["c"].coefficients.numpy().tobytes()
    assert res.training_scores["c"].numpy().tobytes() == clean.training_scores["c"].numpy().tobytes()
    np.testing.assert_allclose(res.model.models["c"].coefficients.numpy(),
                               np.asarray(jres.model.models["c"].coefficients), rtol=1e-6)
    assert [t["call"] for t in res.trackers["c"]] == [t["call"] for t in jres.trackers["c"]] == [1, 3, 4]
    counters = REGISTRY.snapshot("fleet.")["counters"]
    assert counters["fleet.degraded_descents"]["value"] == 1.0 and counters["fleet.peer_lost"]["value"] == 1.0


@pytest.mark.parametrize("case", ["flap_bound", "blocker_aborts", "blocker_still_retries_a_flap",
                                  "validation_mesh_blocks"])
def test_descent_degrade_edges_equal_the_reference(monkeypatch, case):
    monkeypatch.setenv("PHOTON_DESCENT_DEGRADE", "1")
    survivors = [0, 1] if case in ("flap_bound", "blocker_still_retries_a_flap") else [0]
    _arm(monkeypatch, survivors=survivors)

    def run(port):
        coord = _FakeReCoord(port, fail_always=case == "flap_bound",
                             fail_at_call=None if case == "flap_bound" else 1)
        if case.startswith("blocker"):
            coord._degrade_blocker = lambda: "coordinate 'c' spans the mesh"
        cd = _tiny_descent(coord)
        if case == "validation_mesh_blocks":
            from photon_ml_tpu_torch.parallel.mesh import ProcessMesh

            cd.mesh = ProcessMesh(local=(torch.device("cpu"),)) if port else object()
            cd.validation_batch, cd.evaluators = cd.batch, ["AUC"]
        res = cd.run(["c"], 2)
        return coord.calls, len(res.trackers["c"])

    port, ref = _both(run)
    assert port == ref
    expect = {"flap_bound": "links flapped", "blocker_aborts": "cannot degrade in place",
              "validation_mesh_blocks": "cannot degrade in place"}
    if case in expect:
        assert port[0] == "RuntimeError" and expect[case] in port[1]
    else:
        assert port == ("ok", (3, 2))  # the failed call, the re-run iteration 0, iteration 1


# -- fingerprints -------------------------------------------------------------------------


def test_load_checkpoint_accepts_any_listed_fingerprint(tmp_path):
    from photon_ml_tpu_torch.checkpoint import load_checkpoint, peek_fingerprint, save_checkpoint
    from photon_ml_tpu_torch.game.models import GameModel, RandomEffectModel
    from photon_ml_tpu_torch.types import TaskType

    assert peek_fingerprint(str(tmp_path)) is None
    model = GameModel(models={"re": RandomEffectModel(
        coefficients=torch.ones((2, 3)), variances=None, random_effect_type="eid", feature_shard_id="r",
        task_type=TaskType.LOGISTIC_REGRESSION)}, task_type=TaskType.LOGISTIC_REGRESSION)
    save_checkpoint(str(tmp_path), model, next_iteration=2, fingerprint="pre-loss")
    assert peek_fingerprint(str(tmp_path)) == "pre-loss"
    from photon_ml_tpu.checkpoint import peek_fingerprint as jpeek

    assert jpeek(str(tmp_path)) == "pre-loss"
    assert load_checkpoint(str(tmp_path), fingerprint="degraded", device="cpu") is None
    ck = load_checkpoint(str(tmp_path), fingerprint=("degraded", "pre-loss"), device="cpu")
    assert ck is not None and ck.next_iteration == 2 and ck.fingerprint == "pre-loss"
    assert load_checkpoint(str(tmp_path), fingerprint=["pre-loss"], device="cpu") is not None
    assert load_checkpoint(str(tmp_path), fingerprint="pre-loss", device="cpu") is not None


@pytest.mark.parametrize("collection", [True, False])
def test_descent_resume_accepts_the_pre_loss_checkpoint(tmp_path, collection):
    from photon_ml_tpu_torch.checkpoint import batch_digest, save_checkpoint
    from photon_ml_tpu_torch.game.models import GameModel
    from photon_ml_tpu_torch.types import TaskType

    coord = _FakeReCoord(True)
    cd = _tiny_descent(coord)
    save_checkpoint(str(tmp_path), GameModel(models={}, task_type=TaskType.LOGISTIC_REGRESSION),
                    next_iteration=1, fingerprint="pre-loss-layout", scores={"c": np.zeros(4, np.float32)},
                    total=np.zeros(4, np.float32), data_digest=batch_digest(cd.batch.labels, cd.batch.weights))
    cd.run(["c"], 2, checkpoint_dir=str(tmp_path), checkpoint_fingerprint="degraded-layout",
           resume_fingerprints=["pre-loss-layout"] if collection else ())
    assert coord.calls == (1 if collection else 2)  # resumed at iteration 1, or retrained


def test_descent_checkpoint_carries_the_current_iteration(tmp_path):
    """The iteration transaction writes its checkpoint from the advanced
    state: a resumed descent is bitwise the uninterrupted one."""
    clean = _tiny_descent(_FakeReCoord(True)).run(["c"], 3)
    _tiny_descent(_FakeReCoord(True)).run(["c"], 2, checkpoint_dir=str(tmp_path), checkpoint_fingerprint="f")
    resumed = _tiny_descent(_FakeReCoord(True)).run(["c"], 3, checkpoint_dir=str(tmp_path),
                                                    checkpoint_fingerprint="f")
    for a, b in ((resumed.model.models["c"].coefficients, clean.model.models["c"].coefficients),
                 (resumed.training_scores["c"], clean.training_scores["c"])):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# -- elastic rejoin ---------------------------------------------------------------


class TestRejoinSpecGrammar:
    def test_parse_valid_rejoin_spec(self):
        for mod in (faults, jfaults):
            plan = mod.parse_plan('[{"op": "rejoin", "link": [3, 0], "seq": 5, "tag": "offsets", "delay_s": 2.0}]')
            assert plan.specs[0].op == "rejoin" and plan.specs[0].delay_s == 2.0

    def test_rejoin_requires_delay(self):
        for mod in (faults, jfaults):
            with pytest.raises(ValueError, match="rejoin requires delay_s"):
                mod.parse_plan('[{"op": "rejoin", "link": [1, 0], "seq": 1}]')


def test_rejoin_op_relaunches_the_command_as_a_boot_without_the_plan(tmp_path, monkeypatch):
    """The ``rejoin`` op's child: ``PHOTON_REJOIN_CMD`` run after ``delay_s``
    with ``PHOTON_REJOIN_BOOT`` the dying process's index and no fault plan
    (the parent's exit, ``os._exit``, is not taken here)."""
    import json
    import sys

    out = tmp_path / "child.json"
    monkeypatch.setenv("PHOTON_REJOIN_CMD", json.dumps([
        sys.executable, "-c", "import json, os, sys; json.dump({k: os.environ.get(k) for k in "
        "('PHOTON_REJOIN_BOOT', 'PHOTON_FAULT_PLAN', 'MARK')}, open(sys.argv[1], 'w'))", str(out)]))
    monkeypatch.setenv("PHOTON_FAULT_PLAN", VALID_PLANS[3])
    monkeypatch.setenv("MARK", "inherited")
    spec = faults.parse_plan('[{"op": "rejoin", "link": [2, 0], "seq": 1, "delay_s": 0.05}]').specs[0]
    faults._spawn_rejoin_child(spec)
    deadline = time.monotonic() + 30
    while not out.exists() or not out.read_text():
        assert time.monotonic() < deadline, "the relaunched command never ran"
        time.sleep(0.05)
    time.sleep(0.05)
    assert json.loads(out.read_text()) == {"PHOTON_REJOIN_BOOT": "2", "PHOTON_FAULT_PLAN": None, "MARK": "inherited"}


class TestRejoinQuorum:
    def test_rejoiner_does_not_pad_quorum(self):
        for mod in (mh, jmh):
            assert not mod._fragment_may_proceed([2, 9], [0, 1, 2, 3])
            assert mod._fragment_may_proceed([0, 1, 2, 9], [0, 1, 2])

    def test_expanded_rejoin_set_proceeds(self):
        for mod in (mh, jmh):
            assert mod._fragment_may_proceed([0, 1, 2, 3], [0, 1, 2])


def test_coordinator_heartbeats_parse_strictly_and_set_the_gloo_timeout(monkeypatch):
    """``PHOTON_COORD_MAX_MISSING_HEARTBEATS``: a strict int, at least 1,
    read before any work (a typo names the knob, not a cluster problem),
    and the gloo group's timeout in 10 s heartbeats."""
    seen = {}

    def fake_init(backend, **kw):
        seen.update(kw)
        raise RuntimeError("no group here")

    monkeypatch.setattr(mh.dist, "init_process_group", fake_init)
    monkeypatch.delenv("PHOTON_COORD_MAX_MISSING_HEARTBEATS", raising=False)
    assert mh.coord_max_missing_heartbeats() is None
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        mh.initialize_multihost("127.0.0.1:1", 2, 0, timeout_s=45)
    assert seen["timeout"].total_seconds() == 45
    monkeypatch.setenv("PHOTON_COORD_MAX_MISSING_HEARTBEATS", "36")
    assert mh.coord_max_missing_heartbeats() == 36
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        mh.initialize_multihost("127.0.0.1:1", 2, 0, timeout_s=45)
    assert seen["timeout"].total_seconds() == 360
    for bad in ("zz", "1.5", "0", "-2"):
        monkeypatch.setenv("PHOTON_COORD_MAX_MISSING_HEARTBEATS", bad)
        with pytest.raises(ValueError):
            mh.initialize_multihost("127.0.0.1:1", 2, 0)


class TestMeshCacheAndRejoinBootstrap:
    @pytest.fixture(autouse=True)
    def _restore_identity(self, monkeypatch):
        monkeypatch.setattr(mh, "_HOST_ADDRS", None)
        monkeypatch.setattr(jmh, "_HOST_ADDRS", None)
        yield
        mh._REJOIN_IDENTITY = None
        jmh._REJOIN_IDENTITY = None
        mh._DEGRADED = None

    def test_persist_and_bootstrap_roundtrip(self, tmp_path, monkeypatch):
        path = str(tmp_path / "mesh.json")
        addrs = {0: ("127.0.0.1", 4100), 1: ("127.0.0.1", 4101), 2: ("10.0.0.3", 4102)}
        monkeypatch.setenv("PHOTON_MESH_CACHE", path)
        monkeypatch.setattr(mh, "_HOST_ADDRS", dict(addrs))
        with monkeypatch.context() as m:
            m.setattr(mh, "_world_size", lambda: 3)
            mh._maybe_persist_mesh_addrs()
        # the reference writes the same document for the same table
        monkeypatch.setattr(jmh, "_HOST_ADDRS", dict(addrs))
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        monkeypatch.setenv("PHOTON_MESH_CACHE", str(tmp_path / "ref.json"))
        jmh._maybe_persist_mesh_addrs()
        assert (tmp_path / "ref.json").read_bytes() == (tmp_path / "mesh.json").read_bytes()
        # a fresh interpreter (cleared globals) takes its original identity
        monkeypatch.setattr(mh, "_HOST_ADDRS", None)
        assert mh.bootstrap_rejoin(pid=2, path=path) == {"pid": 2, "world": 3}
        assert mh._HOST_ADDRS[2] == ("10.0.0.3", 4102)
        assert (mh.original_process_index(), mh.original_process_count()) == (2, 3)
        # before admission it counts its original group, never a world of one
        assert (mh.effective_process_index(), mh.effective_process_count()) == (2, 3)
        assert not mh.is_output_process()
        mh.require_process_group()  # it belongs to its group through the mesh
        # an expanded group at the original size stays on the mesh
        monkeypatch.setattr(mh, "_reset_host_links", lambda: None)
        mh.set_degraded_group([0, 1, 2])
        assert mh.degraded_group() == {"survivors": (0, 1, 2), "rank": 2}

    def test_nothing_is_written_with_the_knob_unset(self, tmp_path, monkeypatch):
        monkeypatch.delenv("PHOTON_MESH_CACHE", raising=False)
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(mh, "_HOST_ADDRS", {0: ("127.0.0.1", 4100)})
        mh._maybe_persist_mesh_addrs()
        assert list(tmp_path.iterdir()) == []

    def test_bootstrap_rejects_unknown_pid(self, tmp_path, monkeypatch):
        path = str(tmp_path / "mesh.json")
        monkeypatch.setenv("PHOTON_MESH_CACHE", path)
        monkeypatch.setattr(mh, "_HOST_ADDRS", {0: ("127.0.0.1", 4100)})
        mh._maybe_persist_mesh_addrs()
        with pytest.raises(RuntimeError, match="no address for process 7"):
            mh.bootstrap_rejoin(pid=7, path=path)

    def test_bootstrap_requires_cache_path(self, monkeypatch):
        monkeypatch.delenv("PHOTON_MESH_CACHE", raising=False)
        with pytest.raises(RuntimeError, match="PHOTON_MESH_CACHE"):
            mh.bootstrap_rejoin(pid=1)
        monkeypatch.delenv("PHOTON_REJOIN_BOOT", raising=False)
        with pytest.raises(RuntimeError, match="PHOTON_REJOIN_BOOT"):
            mh.bootstrap_rejoin()

    def test_sink_shard_index_follows_rejoin_identity(self, tmp_path, monkeypatch):
        from photon_ml_tpu_torch.obs import sink as obs_sink

        path = str(tmp_path / "mesh.json")
        monkeypatch.setenv("PHOTON_MESH_CACHE", path)
        monkeypatch.setattr(mh, "_HOST_ADDRS", {0: ("127.0.0.1", 4100), 1: ("127.0.0.1", 4101)})
        with monkeypatch.context() as m:
            m.setattr(mh, "_world_size", lambda: 2)
            mh._maybe_persist_mesh_addrs()
        monkeypatch.setenv("PHOTON_REJOIN_BOOT", "1")
        mh.bootstrap_rejoin()
        assert obs_sink._process_index() == 1
        assert obs_sink._process_count() == 2


class TestRejoinRendezvous:
    """The probe, invite and wait over loopback sockets in one process: the
    rejoiner answers probes, ignores a stray mesh hello (the degrade roll
    call's race) and returns the invite."""

    @pytest.fixture(autouse=True)
    def _restore_identity(self, monkeypatch):
        monkeypatch.setattr(mh, "_HOST_ADDRS", None)
        yield
        mh._REJOIN_IDENTITY = None

    @staticmethod
    def _closed_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def test_probe_invite_wait_roundtrip(self, monkeypatch):
        port = self._closed_port()
        monkeypatch.setattr(mh, "_HOST_ADDRS", {0: ("127.0.0.1", 1), 3: ("127.0.0.1", port)})
        mh._REJOIN_IDENTITY = {"pid": 3, "world": 4}
        out = {}
        t = threading.Thread(target=lambda: out.update(invite=mh.rejoin_wait(window_s=10.0)))
        t.start()
        try:
            deadline = time.monotonic() + 5
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", port), timeout=0.5)
                    break
                except OSError:
                    assert time.monotonic() < deadline
                    time.sleep(0.02)
            # a stray mesh hello first (a racing roll call's dial): ignored
            s.sendall(struct.pack("!i", 0 | (1 << 16)))
            s.close()
            # the survivor's side: process 0 probes, then invites
            present = []
            with monkeypatch.context() as m:
                m.setattr(mh, "_self_pid", lambda: 0)
                while not present and time.monotonic() < deadline:
                    present = mh.probe_rejoiners([3], window_s=0.0)
                assert present == [3]
                assert mh.send_rejoin_invites(present, candidates=[0, 1, 3], survivors=[0, 1]) == [3]
        finally:
            t.join(timeout=10)
        assert out["invite"] == {"candidates": [0, 1, 3], "survivors": [0, 1]}

    def test_wait_times_out_uninvited(self, monkeypatch):
        monkeypatch.setattr(mh, "_HOST_ADDRS", {2: ("127.0.0.1", self._closed_port())})
        mh._REJOIN_IDENTITY = {"pid": 2, "world": 3}
        assert mh.rejoin_wait(window_s=0.2) is None

    def test_wait_outside_a_rejoin_boot_raises(self):
        with pytest.raises(RuntimeError, match="bootstrap_rejoin"):
            mh.rejoin_wait(window_s=0.1)

    def test_probe_refused_is_absent(self, monkeypatch):
        monkeypatch.setattr(mh, "_HOST_ADDRS", {1: ("127.0.0.1", self._closed_port())})
        assert mh.probe_rejoiners([1], window_s=0.0) == []


class TestRejoinAdmission:
    """``_maybe_admit_rejoin`` with the group's calls faked, the reference's
    cases; then the rejoin guard of ``_load_resume_state``."""

    @staticmethod
    def _trainer(monkeypatch):
        from photon_ml_tpu_torch.config import (GameTrainingConfig, OptimizationConfig, OptimizerConfig,
                                                RandomEffectCoordinateConfig, RegularizationContext)
        from photon_ml_tpu_torch.game.streaming import StreamedGameTrainer
        from photon_ml_tpu_torch.types import RegularizationType, TaskType, VarianceComputationType

        monkeypatch.setattr(mh, "require_process_group", lambda: None)
        opt = OptimizationConfig(optimizer=OptimizerConfig(max_iterations=2, tolerance=1e-9),
                                 regularization=RegularizationContext(RegularizationType.L2),
                                 regularization_weight=1.0)
        cfg = GameTrainingConfig(
            task_type=TaskType.LOGISTIC_REGRESSION, coordinate_update_sequence=("per_entity",),
            coordinate_descent_iterations=1, fixed_effect_coordinates={},
            random_effect_coordinates={"per_entity": RandomEffectCoordinateConfig(
                random_effect_type="eid", feature_shard_id="r", optimization=opt)},
            variance_computation=VarianceComputationType.SIMPLE)
        return StreamedGameTrainer(cfg, chunk_rows=64, multihost=True, num_entities={"eid": 4},
                                   sharded_checkpoints=False, device="cpu")

    @staticmethod
    def _degraded(monkeypatch, rank=0, probed=(3,), agreed=(0, 1, 2, 3)):
        monkeypatch.setenv("PHOTON_REJOIN", "1")
        monkeypatch.setattr(mh, "degraded_group", lambda: {"survivors": (0, 1, 2), "rank": rank})
        monkeypatch.setattr(mh, "original_process_count", lambda: 4)
        monkeypatch.setattr(mh, "original_process_index", lambda: rank)
        monkeypatch.setattr(mh, "rejoin_window_s", lambda: 0.0)
        monkeypatch.setattr(mh, "effective_process_index", lambda: rank)
        monkeypatch.setattr(mh, "effective_process_count", lambda: 3)
        monkeypatch.setattr(mh, "probe_rejoiners", lambda lost, w: list(probed))
        monkeypatch.setattr(mh, "broadcast_from_host0", lambda x: x)
        monkeypatch.setattr(mh, "send_rejoin_invites", lambda *a, **kw: [3])
        groups = []
        monkeypatch.setattr(mh, "set_degraded_group", lambda s: groups.append(list(s)))
        monkeypatch.setattr(mh, "roll_call", lambda **kw: list(agreed))
        return groups

    @staticmethod
    def _counter(name) -> float:
        from photon_ml_tpu_torch.obs.metrics import REGISTRY

        return REGISTRY.snapshot().get("counters", {}).get(name, {}).get("value", 0.0)

    def test_admitted_rejoin_reanchors_row_base(self, monkeypatch):
        from photon_ml_tpu_torch.game.streaming import _RejoinResume

        trainer = self._trainer(monkeypatch)
        trainer._last_fingerprint = "degraded-layout"
        trainer._last_row_base = 11
        groups = self._degraded(monkeypatch)
        sent = {}
        monkeypatch.setattr(mh, "allgather_obj_p2p",
                            lambda payload, tag=None, **kw: sent.update(tag=tag) or [payload, None, None, None])
        before = self._counter("fleet.rejoins")
        with pytest.raises(_RejoinResume):
            trainer._maybe_admit_rejoin({}, iteration=1, ci=0)
        # the survivor accepts what it sent, and its row base re-anchors to
        # the degraded layout that wrote any checkpoint since the loss
        assert "degraded-layout" in trainer.resume_fingerprints
        assert trainer.resume_row_base == 11
        assert groups == [[0, 1, 2, 3]] and sent["tag"] == "rejoin_ctrl"
        assert self._counter("fleet.rejoins") == before + 1.0

    def test_dropped_survivor_forces_replan_resume(self, monkeypatch):
        from photon_ml_tpu_torch.game.streaming import _RejoinResume

        trainer = self._trainer(monkeypatch)
        trainer._last_fingerprint = "pre-shrink"
        trainer._last_row_base = 7
        # survivor 2 and the probed rejoiner both die before the roll call
        groups = self._degraded(monkeypatch, agreed=(0, 1))
        before = self._counter("fleet.recoveries")
        with pytest.raises(_RejoinResume):
            trainer._maybe_admit_rejoin({}, iteration=0, ci=0)
        assert groups == [[0, 1]]
        assert "pre-shrink" in trainer.resume_fingerprints and trainer.resume_row_base == 7
        assert self._counter("fleet.recoveries") == before + 1.0

    def test_admit_and_drop_in_one_round_roots_at_live_survivor(self, monkeypatch):
        """Process 0 dies between the probe and the roll call, which admits 3
        and drops 0 in one round: the anchors come from process 1, the
        lowest survivor still in the group."""
        from photon_ml_tpu_torch.game.streaming import _RejoinResume

        trainer = self._trainer(monkeypatch)
        trainer._last_fingerprint = "degraded-layout"
        trainer._last_row_base = 5
        self._degraded(monkeypatch, rank=1, probed=(), agreed=(1, 2, 3))
        monkeypatch.setattr(mh, "broadcast_from_host0", lambda x: np.asarray([3], np.int64))
        sent = {}

        def fake_allgather(payload, tag=None, **kw):
            sent["payload"] = payload
            return [payload, None, None]

        monkeypatch.setattr(mh, "allgather_obj_p2p", fake_allgather)
        with pytest.raises(_RejoinResume):
            trainer._maybe_admit_rejoin({}, iteration=2, ci=0)
        assert sent["payload"]["fingerprints"] == ["degraded-layout"]
        assert "degraded-layout" in trainer.resume_fingerprints and trainer.resume_row_base == 5

    def test_vanished_rejoiner_alone_keeps_training(self, monkeypatch):
        trainer = self._trainer(monkeypatch)
        # the roll call agrees on the current group: training goes on in place
        self._degraded(monkeypatch, agreed=(0, 1, 2))
        assert trainer._maybe_admit_rejoin({}, iteration=0, ci=0) is None

    def test_whole_group_and_knob_off_probe_nothing(self, monkeypatch):
        trainer = self._trainer(monkeypatch)
        self._degraded(monkeypatch)
        monkeypatch.setattr(mh, "probe_rejoiners", lambda *a: pytest.fail("probed"))
        monkeypatch.setenv("PHOTON_REJOIN", "0")
        assert trainer._maybe_admit_rejoin({}, iteration=0, ci=0) is None
        monkeypatch.setenv("PHOTON_REJOIN", "1")
        monkeypatch.setattr(mh, "degraded_group", lambda: None)
        assert trainer._maybe_admit_rejoin({}, iteration=0, ci=0) is None

    def test_a_rejoiner_refuses_a_degraded_layout_s_gathered_checkpoint(self, monkeypatch, tmp_path):
        """The rejoin guard: a gathered checkpoint of another layout (a
        degraded group's, written after the loss) holds none of a
        rejoiner's rows; any other process takes it as before."""
        from types import SimpleNamespace

        from photon_ml_tpu_torch.game import streaming

        trainer = self._trainer(monkeypatch)
        trainer.checkpoint_dir = str(tmp_path)
        ckpt = SimpleNamespace(model=None, next_iteration=1, next_coordinate=0, fingerprint="degraded",
                               scores={"per_entity": np.zeros(4, np.float32)}, total=np.zeros(4, np.float32))
        monkeypatch.setattr(streaming.ckpt_io, "load_checkpoint", lambda *a, **kw: ckpt)
        monkeypatch.setattr(mh, "broadcast_from_host0", lambda x: x)
        monkeypatch.setattr(trainer, "_distributed", lambda: True)
        trainer.resume_fingerprints = ["degraded"]
        state = trainer._load_resume_state("expanded", "digest")
        assert state["foreign"] and not state["scores_local"]
        monkeypatch.setattr(mh, "rejoin_identity", lambda: {"pid": 3, "world": 4})
        with pytest.raises(RuntimeError, match="degraded layout"):
            trainer._load_resume_state("expanded", "digest")
        ckpt.fingerprint = "expanded"  # the checkpoint written before the loss: taken
        assert not trainer._load_resume_state("expanded", "digest")["foreign"]

