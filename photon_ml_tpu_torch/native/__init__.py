"""Native (C++) host code of the port, built with ``g++`` at first use by
``build.py``: the mmap'd feature-index store (``index_store.cc``, bound by
``NativeIndexStore``) and the columnar Avro decoder (``avro_ingest.cc``)."""

from photon_ml_tpu_torch.native.index_store import NativeIndexStore  # noqa: F401
