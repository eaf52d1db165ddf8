"""Nested host-side spans and structured events (port of
``photon_ml_tpu/obs/spans.py``).

``span("descent/iter", iteration=it)`` opens a named wall-clock span.
Spans nest through a thread-local stack, so the prefetch workers each
build their own span tree instead of adopting whatever the consumer
thread has open. A span is emitted on exit as one complete record (name,
ids, thread, start time, duration, attributes), which maps one to one onto
a Chrome-trace complete event.

Spans time the host's wall around asynchronous CUDA work, as the
reference's time it around asynchronous dispatch: nothing here
synchronizes the card. At a root span's exit the card's memory
watermarks are sampled (``devcost.sample_hbm_watermarks``, rate-limited).

With no sink, ``span()`` returns one shared no-op context manager: no
allocation, no stack, no clock read.
"""

from __future__ import annotations

import itertools
import threading
import time

from photon_ml_tpu_torch.obs import sink as _sink_mod

# span ids are unique in the process; itertools.count is atomic under the GIL
_ids = itertools.count(1)
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _NoopSpan:
    """The shared do-nothing context manager (no sink)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "t0", "start_unix")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        self.span_id = next(_ids)
        st.append(self)
        self.start_unix = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        st = _stack()
        # tolerate exotic unwind orders; normal exits pop the top
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        s = _sink_mod.active_sink()
        if s is not None:
            th = threading.current_thread()
            rec = {
                "event": "span",
                "t": self.start_unix,
                "name": self.name,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "tid": th.ident,
                "thread": th.name,
                "dur_s": dur,
            }
            if self.attrs:
                rec["attrs"] = self.attrs
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            s.emit(rec)
            if self.parent_id is None:
                # a root span's exit: sample the card's memory watermarks
                # (per fit or driver stage, never per iteration; the
                # sampler is rate-limited and never raises)
                try:
                    from photon_ml_tpu_torch.obs import devcost

                    devcost.sample_hbm_watermarks(root_span=self.name)
                except Exception:
                    pass
        return False


def span(name: str, **attrs):
    """A nested wall-clock span; a no-op singleton when telemetry is off."""
    if _sink_mod.active_sink() is None:
        return NOOP_SPAN
    return _Span(name, attrs)


def current_span_id() -> int | None:
    st = getattr(_tls, "stack", None)
    return st[-1].span_id if st else None


def emit_event(event: str, **payload) -> None:
    """Emit one structured record (attributed to the current thread's open
    span, if any). A no-op when telemetry is disabled."""
    s = _sink_mod.active_sink()
    if s is None:
        return
    rec = {"event": event, "t": time.time()}
    sid = current_span_id()
    if sid is not None:
        rec["span_id_ref"] = sid
    rec.update(payload)
    s.emit(rec)


def emit_log(level: str, message: str, fields: dict | None = None) -> None:
    """The structured twin of a ``PhotonLogger`` WARN or ERROR line (the
    logger's default event hook)."""
    s = _sink_mod.active_sink()
    if s is None:
        return
    rec = {"event": "log", "t": time.time(), "level": level,
           "message": message}
    sid = current_span_id()
    if sid is not None:
        rec["span_id_ref"] = sid
    if fields:
        rec["fields"] = fields
    s.emit(rec)
