"""Shared utilities: logging, stage timing, device traces, atomic file writes."""

from photon_ml_tpu_torch.utils.atomic_io import (  # noqa: F401
    atomic_replace,
    atomic_replace_bytes,
    atomic_savez,
)
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed  # noqa: F401
from photon_ml_tpu_torch.utils.profiling import annotate, profile_trace  # noqa: F401
