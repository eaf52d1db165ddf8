"""Static analysis of the port's load-bearing disciplines (the port's
counterpart of ``photon_ml_tpu/analysis``, its own copy: nothing here
imports the reference).

``photon-ml-tpu-torch lint`` runs five AST passes over
``photon_ml_tpu_torch/`` and the port's README knob table:

1. **knobs**: every ``PHOTON_*`` knob the port reads registered
   (``analysis/registry.py``) with a strict parse idiom, and the mirror
   surfaces wired (``obs/sink._knob_snapshot``,
   ``obs/devcost._knob_raw_state``, the README table), drift failing in
   both directions.
2. **cache-keys**: no knob accessor / knob-mirroring global / env read
   inside a CUDA graph capture, a ``torch.compile``d function or a
   ``functools`` cache (the stale-program class).
3. **concurrency**: no unlocked mutation of module-level containers in
   worker-pool / process-wide-cache modules.
4. **exceptions**: no silent ``except`` swallow in ``parallel/``,
   ``game/streaming.py``, ``game/descent.py``.
5. **telemetry**: emitted event/metric names and the names the port's
   ``obs/report.py`` / ``obs/export.py`` consume agree, both directions.

Pure stdlib ``ast``: no checked module is imported, so a lint run
loads no kernel and touches no card.
"""

from photon_ml_tpu_torch.analysis.core import Finding, Project  # noqa: F401
from photon_ml_tpu_torch.analysis.registry import KNOBS, Knob  # noqa: F401
from photon_ml_tpu_torch.analysis.runner import PASSES, discover_root, lint  # noqa: F401
