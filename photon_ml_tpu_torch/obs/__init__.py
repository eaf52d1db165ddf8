"""Run telemetry: spans, the metrics registry, the JSONL sink, the
Chrome-trace export and the kernels' analytic cost (port of
``photon_ml_tpu/obs``).

- **spans** (``span("descent/iter", iteration=it)``): nested host-side
  wall-clock spans, each thread with its own stack;
- **metrics registry** (``metrics.REGISTRY``): counters, gauges,
  histograms and timers, always on (``utils/profiling``'s stage timers
  are a view of it);
- **JSONL sink** (``configure(telemetry_dir)`` ... ``shutdown()``): one
  run, one schema-versioned file, committed by atomic rotation, one
  writer across processes (or one shard each under
  ``PHOTON_TELEMETRY_FLEET=1``);
- **readers and exporters**: ``obs.report`` loads and validates a run,
  ``obs.export`` renders it as a Chrome trace beside the ``torch.profiler``
  traces of ``--profile-dir``;
- **analytic device cost** (``obs.devcost``): the bytes and operations of
  each kernel launch signature, captured at the launchers, and the cards'
  memory watermarks.

The names (span names, record kinds and fields, registry names, the
schema version) are the reference's, so ``obs.report`` (the
``photon-ml-tpu-torch report`` command) and the reference's
``photon-ml-tpu report`` both read a port run. With no sink, spans are a shared no-op and an event is
one attribute check, so the instrumentation stays wired through the
production paths.
"""

from photon_ml_tpu_torch.obs import devcost  # noqa: F401
from photon_ml_tpu_torch.obs import metrics  # noqa: F401
from photon_ml_tpu_torch.obs.devcost import capture as capture_executable_cost  # noqa: F401
from photon_ml_tpu_torch.obs.metrics import REGISTRY  # noqa: F401
from photon_ml_tpu_torch.obs.sink import (  # noqa: F401
    SCHEMA_VERSION,
    TelemetrySink,
    active_sink,
    configure,
    shutdown,
)
from photon_ml_tpu_torch.obs.spans import (  # noqa: F401
    NOOP_SPAN,
    current_span_id,
    emit_event,
    emit_log,
    span,
)


def enabled() -> bool:
    return active_sink() is not None
