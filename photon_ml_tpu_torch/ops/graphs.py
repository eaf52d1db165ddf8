"""Loops whose trips the device decides, captured CUDA graphs, and the reads
a captured run defers to its end.

A solver's iteration is written once, as a body that reads its state
tensors, writes the new state in place (``copy_`` under per-lane masks)
and rewrites a 0-d bool flag, "go on". ``loop(trips, flag, body)`` runs
it under one of two drivers, passing ``body`` the trip's index where the
host knows it and None where the device decides it (a body may bound work
that is exactly a no-op past a count by it, as the two-loop recursion's
masked steps are):

- the eager driver (CPU tensors, or CUDA tensors outside a capture): the
  host reads the flag before each trip and stops at the first false or
  after ``trips`` trips: one read a trip, as the host loops always made;
- the device driver (inside ``capture``): the body is captured once, into
  a segment of its own, and becomes the body of a CUDA WHILE conditional
  node that the device re-enters while the flag holds and a trip counter
  is below ``trips``. Nothing is read on the host; a trip the flag stops
  costs no kernel.

Both drivers run the same body, so a captured replay does what the eager
loop does. The body must not branch in Python on a tensor's value, and
anything it computes that outlives it must land in a tensor allocated
before the loop (a trip the device skips writes nothing). The flag is the
loop's own: the device driver also clears it when the trips run out.

``capture(fn, stream)`` runs ``fn`` once with its CUDA work captured: the
straight-line work between loops in segments (torch ``CUDAGraph``s kept
uninstantiated, all in one memory pool), which ``csrc/graphs/while_loops.cu``
composes with the loops' WHILE nodes into one graph. A capture that fails
raises: nothing falls back to the eager loop on the card. The returned
``LoopGraph`` replays the whole of it with one launch on the current
stream, reading and writing the same tensors as the capture did. The
capture stream must have run ``fn`` once eagerly first (a warm-up: the
libraries' handles and workspaces and the kernels' per-stream buffers
then exist before the capture).

``deferring()`` collects the reads that code would make at once outside
a captured run: ``defer(tensors, fn)`` registers ``fn(host_arrays)``,
which the owner of the run calls after its end, with the values of one
transfer (``read_all``). ``count_launch`` counts a hand-written kernel's
launch on the host, or, inside a capture, on a device counter allocated
before it, which ``take_device_counts`` reads back.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


class _Capture:
    """One capture in progress: the open segment, the stack of item lists
    (a segment, or a loop with its flag and its body's items) and every
    tensor and torch graph the composed graph goes on reading."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: list = []
        self.keep: list[Tensor] = []
        self.items: list[list] = [[]]
        self.open = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self.open = g

    def end(self) -> None:
        g, self.open = self.open, None
        with warnings.catch_warnings():  # a segment may hold no work (two loops back to back)
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            g.capture_end()
        self.segments.append(g)
        self.items[-1].append(("graph", g))


_captures: list[_Capture] = []
_deferred: list[list] = []


def capturing() -> bool:
    """Is a ``capture`` in progress?"""
    return bool(_captures)


def loop(trips: int, flag: Tensor, body: Callable[[int | None], None]) -> int | None:
    """At most ``trips`` runs of ``body(trip)`` while ``flag`` holds (module
    docstring). Returns the trips run under the eager driver, None under
    the device driver (the device decides them)."""
    if trips <= 0:
        return 0
    if not (_captures and flag.is_cuda):
        for i in range(trips):
            if not bool(flag):
                return i
            body(i)
        return trips
    cap = _captures[-1]
    trip = torch.zeros((), dtype=torch.int64, device=flag.device)  # zeroed each time the loop is entered
    cap.keep += [flag, trip]
    cap.end()
    cap.items.append([])
    cap.begin()
    body(None)
    trip.add_(1)
    flag.logical_and_(trip < trips)
    cap.end()
    items = cap.items.pop()
    cap.items[-1].append(("loop", flag, items))
    cap.begin()
    return None


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


class LoopGraph:
    """A composed graph (``capture``): ``replay()`` launches it on the
    current stream. It keeps the torch segments (their memory pool holds
    every tensor the capture allocated) and the loops' flags."""

    def __init__(self, cap: _Capture):
        from photon_ml_tpu_torch.ops import _cuda

        self._lib = lib = _cuda.load()
        self._segments, self._keep, self.device = cap.segments, cap.keep, cap.device
        self.nodes = 0
        self._exec = None
        out = _void()
        _check(lib.photon_graph_create(out), "cudaGraphCreate")
        self._top = out.value
        self._compose(cap.items[0], self._top)
        out = _void()
        _check(lib.photon_graph_instantiate(self._top, out), "cudaGraphInstantiate")
        self._exec = out.value

    def _compose(self, items: list, graph) -> int | None:
        lib, prev = self._lib, None
        for kind, *rest in items:
            if kind == "graph":
                raw = rest[0].raw_cuda_graph()
                count = _ull()
                _check(lib.photon_graph_node_count(raw, count), "cudaGraphGetNodes")
                if count.value == 0:
                    continue
                self.nodes += count.value
                node = _void()
                _check(lib.photon_graph_add_child(graph, prev, raw, node), "cudaGraphAddChildGraphNode")
                prev = node.value
            else:
                flag, body_items = rest
                node, body, handle = _void(), _void(), _ull()
                _check(lib.photon_graph_add_while(graph, prev, flag.data_ptr(), node, body, handle),
                       "adding a WHILE conditional node")
                last = self._compose(body_items, body.value)
                done = _void()
                _check(lib.photon_graph_add_set(body.value, last, handle.value, flag.data_ptr(), done),
                       "adding a condition kernel node")
                self.nodes += 3
                prev = node.value
        return prev

    def replay(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(self._lib.photon_graph_launch(self._exec, stream), "cudaGraphLaunch")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "_exec", None):
            lib.photon_graph_exec_destroy(self._exec)
        if getattr(self, "_top", None):
            lib.photon_graph_destroy(self._top)


def _void():
    import ctypes

    return ctypes.c_void_p()


def _ull():
    import ctypes

    return ctypes.c_ulonglong()


_capture_streams: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream warm-ups and captures run on, one a device: the
    per-stream buffers a warm-up makes there (cuBLAS workspaces, K1's
    partials) serve every later capture."""
    stream = _capture_streams.get(device.index)
    if stream is None:
        stream = _capture_streams[device.index] = torch.cuda.Stream(device)
    return stream


def capture(fn: Callable[[], object], device: torch.device, stream: torch.cuda.Stream):
    """``fn()`` run once with its work captured on ``stream`` (module
    docstring): returns (``LoopGraph``, what ``fn`` returned: tensors the
    graph writes at every replay). Any failure raises ``RuntimeError``."""
    cap = _Capture(device)
    _captures.append(cap)
    try:
        with torch.cuda.stream(stream):
            try:
                cap.begin()
                out = fn()
                cap.end()
            except Exception as e:
                if cap.open is not None:  # end the capture on its own stream, so the stream is usable again
                    with contextlib.suppress(Exception):
                        cap.open.capture_end()
                raise RuntimeError(f"capturing a CUDA graph failed: {e}") from e
    finally:
        _captures.pop()
    try:
        return LoopGraph(cap), out
    except Exception as e:
        raise RuntimeError(f"composing the captured CUDA graph failed: {e}") from e


# ---------------------------------------------------------------------------
# reads deferred to the end of a run
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def deferring():
    """Collect ``defer`` registrations (a list of (tensors, fn)) while
    active: the run whose reads wait for its end."""
    got: list = []
    _deferred.append(got)
    try:
        yield got
    finally:
        _deferred.pop()


def is_deferring() -> bool:
    return bool(_deferred)


def defer(tensors: Sequence[Tensor], fn: Callable[[list[np.ndarray]], None]) -> None:
    """Register ``fn``, called after the run with ``tensors``' values."""
    _deferred[-1].append((tuple(tensors), fn))


def read_all(tensors: Sequence[Tensor]) -> list[np.ndarray]:
    """Every tensor's values in one transfer, as float64 arrays of their
    shapes (exact for float32 values and for counts below 2^53)."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(device=tensors[0].device, dtype=torch.float64)
                      for t in tensors]).cpu().numpy()
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].reshape(tuple(t.shape)))
        lo += t.numel()
    return out


# ---------------------------------------------------------------------------
# kernel launch counts inside captures
# ---------------------------------------------------------------------------
_device_counts: dict[tuple[str, int], tuple[Tensor, Callable[[int], None]]] = {}


def count_launch(name: str, device: torch.device, on_host: Callable[[int], None]) -> None:
    """One launch of kernel ``name``: ``on_host(1)`` at once, or, inside a
    capture, one added on the device (each replay then counts the launches
    it makes, a loop's skipped trips none). The device counter is made at
    the kernel's first eager launch on the device, before any capture."""
    key = (name, device.index)
    entry = _device_counts.get(key)
    if _captures:
        if entry is None:
            raise RuntimeError(f"{name} launched inside a capture before any eager launch on {device}")
        entry[0].add_(1)
        return
    if entry is None:
        _device_counts[key] = (torch.zeros((), dtype=torch.int64, device=device), on_host)
    on_host(1)


def take_device_counts() -> list[tuple[Tensor, Callable[[int], None]]]:
    """Every device counter and its host sink, for one read; the caller
    adds the values read to the sinks and then calls ``zero_device_counts``."""
    return list(_device_counts.values())


def zero_device_counts() -> None:
    for t, _ in _device_counts.values():
        t.zero_()
