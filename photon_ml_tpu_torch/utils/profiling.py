"""Device traces and stage timers (port of ``photon_ml_tpu/utils/profiling.py``).

The drivers take ``--profile-dir``: when it is set, the expensive phases
(the fit, the score pass) run under ``torch.profiler`` with the CPU and
CUDA activities, and each phase's Chrome trace lands in its own
subdirectory, to open in Perfetto beside the run's telemetry export.

The stage timers (``stage_timer``, ``add_seconds``, ``counter_snapshot``,
``reset_counters``) are a view of the timer kind of the metrics registry
(``obs/metrics.py``): the chunk pipeline's ``prefetch.host_pack_s`` /
``device_put_s`` / ``consumer_wait_s`` land there, and so in every
telemetry ``run_end`` record. Thread-safe: prefetch workers add
concurrently.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

from photon_ml_tpu_torch.obs.metrics import REGISTRY as _REGISTRY


@contextlib.contextmanager
def profile_trace(profile_dir: str | None, label: str = "trace") -> Iterator[None]:
    """Trace the enclosed block into ``profile_dir/label/`` as a Chrome
    trace (``trace.json``); a no-op when ``profile_dir`` is None. The CUDA
    activity is asked for only where CUDA is available."""
    if profile_dir is None:
        yield
        return
    import torch

    target = os.path.join(profile_dir, label)
    os.makedirs(target, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, "trace.json"))


def annotate(name: str):
    """A named range inside an active trace (``record_function``), usable
    as a context manager around a hot call's host side."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    """Add the enclosed block's wall seconds to the timer ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REGISTRY.timer_add(name, time.perf_counter() - t0)


def add_seconds(name: str, seconds: float) -> None:
    _REGISTRY.timer_add(name, float(seconds))


def counter_snapshot(prefix: str | None = None) -> dict:
    """``{name: {"seconds", "calls"}}``, optionally filtered by prefix."""
    return _REGISTRY.timer_snapshot(prefix)


def reset_counters(prefix: str | None = None) -> None:
    _REGISTRY.reset_timers(prefix)
