"""Name-and-term feature-bag driver (port of
``photon_ml_tpu/cli/name_term_bags.py``; the reference's
``NameAndTermFeatureBagsDriver``).

Collects the distinct (name, term) pairs of each feature bag across the
data and writes them as bag lists (used downstream to define feature
shards). Output: one JSON file per bag with its sorted pairs, the
reference's bytes for the same data. The records are read by the native
columnar decoder, one thread per part file, each distinct pair crossing
into Python once; when a file's schema lies outside the decoder's
envelope, every file is read by the Python codec, as the reference reads
them. Host only: it takes no ``--device``.

Usage:
    python -m photon_ml_tpu_torch.cli.name_term_bags \\
        --data data/train --bags features userFeatures --output-dir bags/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

from photon_ml_tpu_torch.io.avro import iter_avro_directory, list_avro_files, read_avro_schema
from photon_ml_tpu_torch.io.native_ingest import OutsideEnvelope, compile_program, decode_file, split_pair_key
from photon_ml_tpu_torch.utils import PhotonLogger, timed


def _native_pairs(data: list[str], bags: list[str], logger: PhotonLogger) -> dict[str, set] | None:
    """Each bag's distinct (name, term) pairs by the native decoder; None
    when a file's schema lies outside its envelope."""
    files = [f for p in data for f in list_avro_files(p)]
    try:
        # the uid is parsed (its union is in the envelope) and dropped
        plans = [(f, dataclasses.replace(compile_program(read_avro_schema(f), bags, {}, None, "uid", pair_keys=True),
                                         capture_uid=False)) for f in files]
    except OutsideEnvelope as e:
        logger.info(f"schema outside the native decoder's envelope ({e}); reading with the Python codec")
        return None
    seen: dict[str, set[tuple[str, str]]] = {b: set() for b in bags}
    with ThreadPoolExecutor(max_workers=max(1, min(len(plans), os.cpu_count() or 1))) as pool:
        for c in pool.map(lambda plan: decode_file(plan[0], plan[1], []), plans):
            for bag in seen:
                seen[bag].update(map(split_pair_key, c.bags[bag]["uniq_keys"]))
    return seen


def run(data: list[str], bags: list[str], output_dir: str,
        logger: PhotonLogger | None = None) -> dict[str, list[tuple[str, str]]]:
    logger = logger or PhotonLogger(output_dir)
    with timed(logger, "scan data"):
        seen = _native_pairs(data, bags, logger)
        if seen is None:
            seen = {b: set() for b in bags}
            for p in data:
                for rec in iter_avro_directory(p):
                    for bag in bags:
                        for ntv in rec.get(bag) or ():
                            seen[bag].add((ntv["name"], ntv["term"]))
    os.makedirs(output_dir, exist_ok=True)
    out: dict[str, list[tuple[str, str]]] = {}
    for bag, pairs in seen.items():
        out[bag] = sorted(pairs)
        with open(os.path.join(output_dir, f"{bag}.json"), "w") as f:
            json.dump([{"name": n, "term": t} for n, t in out[bag]], f, indent=2)
        logger.info(f"bag {bag}: {len(pairs)} distinct name-term pairs")
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Name-and-term feature bags driver (PyTorch/CUDA port)")
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--bags", required=True, nargs="+")
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)
    run(args.data, args.bags, args.output_dir)


if __name__ == "__main__":
    main()
