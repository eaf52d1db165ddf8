#!/usr/bin/env python3
"""ms a record of the port's ``AvroDataReader`` on its two paths, the native
columnar decoder and the Python codec, at config E's widths.

    python3 scripts/avro_read_speed.py [--records 20000] [--parts 2] [--dir DIR]

Writes ``--records`` ``TrainingExampleAvro`` records (64 global features,
8 per user and 8 per item, float32 values from a seeded generator, deflate)
in ``--parts`` part files under ``--dir`` (a temporary directory by
default, removed at the end), then reads them on the host (``device="cpu"``)
natively, with the Python codec and natively again, and prints one JSON
line per read with its ms a record. Runs without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from photon_ml_tpu_torch.config import FeatureShardConfig  # noqa: E402
from photon_ml_tpu_torch.io.avro import write_avro_file  # noqa: E402
from photon_ml_tpu_torch.io.data_reader import AvroDataReader  # noqa: E402
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA  # noqa: E402

BAGS = {"userId": "userFeatures", "itemId": "itemFeatures"}


def write_parts(root: str, n: int, parts: int, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 64)).astype(np.float32).tolist()
    E = {k: rng.normal(size=(n, 8)).astype(np.float32).tolist() for k in BAGS}
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    for bag in BAGS.values():
        schema["fields"].insert(5, {"name": bag, "type": {"type": "array", "items": "NameTermValueAvro"},
                                    "default": []})

    def records(rows):
        for i in rows:
            rec = {"uid": i, "response": float(i % 2), "offset": None, "weight": None,
                   "features": [{"name": "g", "term": str(j), "value": v} for j, v in enumerate(X[i])],
                   "metadataMap": {"userId": f"u{i % 3000}", "itemId": f"i{i % 700}"}}
            for k, bag in BAGS.items():
                rec[bag] = [{"name": k, "term": str(j), "value": v} for j, v in enumerate(E[k][i])]
            yield rec

    step = n // parts
    for p in range(parts):
        write_avro_file(os.path.join(root, f"part-{p:05d}.avro"), schema, records(range(p * step, (p + 1) * step)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=20_000)
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    root = args.dir or tempfile.mkdtemp(prefix="avro_read_speed-")
    try:
        os.makedirs(root, exist_ok=True)
        write_parts(root, args.records, args.parts)
        shards = {"global": FeatureShardConfig(("features",), True),
                  **{f"per_{k}": FeatureShardConfig((bag,), False) for k, bag in BAGS.items()}}
        reader = AvroDataReader(shards)
        n = args.records // args.parts * args.parts
        for use_native in (True, False, True):
            t0 = time.perf_counter()
            ds = reader.read(root, id_tags=tuple(BAGS), device="cpu", use_native=use_native)
            print(json.dumps({"decoder": ds.decoder, "records": n,
                              "ms_per_record": 1e3 * (time.perf_counter() - t0) / n}))
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
