"""Online serving: ``photon-ml-tpu-torch serve`` (port of
``photon_ml_tpu/serve``).

- ``store``: ``HotModelStore``, a published GAME model's fixed effects on
  the device whole and its per-entity random-effect rows through a
  byte-budgeted LRU hot set (``ops/bytelru``; knob
  ``PHOTON_SERVE_HOT_BYTES``);
- ``router``: micro-window batching (flush at ``PHOTON_SERVE_MAX_BATCH``
  requests or ``PHOTON_SERVE_MAX_WAIT_MS``) scored at one padded window
  shape, bitwise the batch scorer; across processes, requests travel to
  their entity's owner over ``multihost.exchange_rows``;
- ``refresh``: per-entity refresh, a warm-started one-lane solve through
  the chunked solvers, bitwise the offline solve of the same bucket (knob
  ``PHOTON_SERVE_REFRESH_EVERY``);
- ``loadgen``: the Zipf open-loop load generator, recording p50 / p99
  latency, hot-set hit rate and window occupancy into telemetry.
"""

from photon_ml_tpu_torch.serve.loadgen import open_loop_arrivals, run_serve_trace, zipf_entity_trace  # noqa: F401
from photon_ml_tpu_torch.serve.refresh import refresh_entity  # noqa: F401
from photon_ml_tpu_torch.serve.router import MicroWindowServer, ScoreRequest  # noqa: F401
from photon_ml_tpu_torch.serve.store import HotModelStore  # noqa: F401
