"""Native (C++) host code of the port: the columnar Avro decoder
(``avro_ingest.cc``), built with ``g++`` at first use by ``build.py``."""
