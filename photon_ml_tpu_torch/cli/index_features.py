"""Feature indexing driver (port of ``photon_ml_tpu/cli/index_features.py``;
the reference's ``FeatureIndexingDriver``).

An offline job that scans data, collects the distinct (name, term) pairs
of each feature shard, and writes index maps that training jobs load
instead of re-scanning: one ``IndexMap`` ``.npz`` a shard plus
``_sizes.json``, the reference's files for the same data. The scan is
the reader's streaming index-map pass (``build_index_maps_streaming``): the
native columnar decoder, one part file at a time, or the Python codec
when a file's schema lies outside the decoder's envelope; either holds
the distinct keys, never the records. The GAME training driver reads the
maps with ``--index-maps DIR``. Host only: it takes no ``--device``.

Usage:
    python -m photon_ml_tpu_torch.cli.index_features \\
        --data data/train --config config.json --output-dir index/
"""

from __future__ import annotations

import argparse
import json
import os

from photon_ml_tpu_torch.cli.common import load_training_config
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.utils import PhotonLogger, timed


def run(data: list[str], output_dir: str, config_path: str | None = None,
        logger: PhotonLogger | None = None):
    logger = logger or PhotonLogger(output_dir)
    shards = None
    if config_path:
        shards = dict(load_training_config(config_path).feature_shards)
    reader = AvroDataReader(shards)
    with timed(logger, "scan data"):
        maps = reader.build_index_maps_streaming(list(data))
    with timed(logger, "write index stores"):
        sizes = {}
        for sid, imap in maps.items():
            imap.save(os.path.join(output_dir, sid))
            sizes[sid] = imap.size
        with open(os.path.join(output_dir, "_sizes.json"), "w") as f:
            json.dump(sizes, f)
    logger.info(f"index maps written: {sizes}")
    return maps


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Feature indexing driver (PyTorch/CUDA port)")
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--config", default=None)
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)
    run(args.data, args.output_dir, config_path=args.config)


if __name__ == "__main__":
    main()
