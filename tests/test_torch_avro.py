"""The port's Avro codec against the JAX package's: records written by one
are read by the other exactly, on both codecs, across several blocks, with
negative and large longs, nulls, unions, maps and every primitive type;
a corrupt sync marker or a truncated file is detected."""

from __future__ import annotations

import json

import numpy as np
import pytest

from photon_ml_tpu.io import avro as ref
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA as REF_TRAINING_SCHEMA
from photon_ml_tpu_torch.io import avro as port
from photon_ml_tpu_torch.io.schemas import (
    BAYESIAN_LINEAR_MODEL_SCHEMA,
    FEATURE_SUMMARIZATION_RESULT_SCHEMA,
    SCORING_RESULT_SCHEMA,
    TRAINING_EXAMPLE_SCHEMA,
)

WRITERS = {"port": port.write_avro_file, "ref": ref.write_avro_file}
READERS = {"port": port.read_avro_file, "ref": ref.read_avro_file}
DIRECTIONS = [("port", "ref"), ("ref", "port")]

# every type the codec takes, unions with each branch taken
ALL_TYPES_SCHEMA = {
    "type": "record",
    "name": "AllTypes",
    "namespace": "test.ns",
    "fields": [
        {"name": "b", "type": "boolean"},
        {"name": "i", "type": "int"},
        {"name": "l", "type": "long"},
        {"name": "f", "type": "float"},
        {"name": "d", "type": "double"},
        {"name": "s", "type": "string"},
        {"name": "raw", "type": "bytes"},
        {"name": "fx", "type": {"type": "fixed", "name": "Four", "namespace": "test.ns", "size": 4}},
        {"name": "e", "type": {"type": "enum", "name": "Color", "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "u", "type": ["null", "string", "long", "double", "boolean"]},
        {"name": "m", "type": {"type": "map", "values": ["null", "double"]}},
        {"name": "nested", "type": {"type": "array", "items": {"type": "array", "items": "long"}}},
        {"name": "again", "type": ["null", "Color"], "default": None},
        {"name": "inner", "type": {"type": "record", "name": "Inner",
                                   "fields": [{"name": "x", "type": "Four"},
                                              {"name": "y", "type": "test.ns.Four"}]}},
    ],
}


def _all_types_records(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    unions = [None, "text", -(2**40), 2.5, True]
    recs = []
    for i in range(n):
        recs.append({
            "b": bool(i % 2),
            "i": int(rng.integers(-(2**31), 2**31)),
            "l": int(rng.integers(-(2**62), 2**62)),
            "f": float(np.float32(rng.normal())),  # exact in float32
            "d": float(rng.normal()),
            "s": f"ünïcode-{i}",
            "raw": bytes(rng.integers(0, 256, size=i % 5, dtype=np.uint8)),
            "fx": bytes([i % 256, 1, 2, 3]),
            "e": ["RED", "GREEN", "BLUE"][i % 3],
            "u": unions[i % len(unions)],
            "m": {} if i % 4 == 0 else {f"k{j}": (None if j == 1 else float(j)) for j in range(i % 4)},
            "nested": [[j, -j] for j in range(i % 3)],
            "again": None if i % 2 else "BLUE",
            "inner": {"x": b"abcd", "y": b"efgh"},
        })
    return recs


def _training_records(n: int) -> list[dict]:
    rng = np.random.default_rng(3)
    return [
        {
            "uid": [f"u{i}", i, None][i % 3],
            "response": float(i % 2),
            "offset": 0.5 if i % 3 == 0 else None,
            "weight": None if i % 4 else 2.0,
            "features": [
                {"name": "age", "term": "", "value": float(np.float32(rng.normal()))},
                {"name": "country", "term": "us", "value": 1.0},
            ][: i % 3],
            "metadataMap": None if i % 5 == 0 else {"userId": f"user_{i % 7}"},
        }
        for i in range(n)
    ]


def _roundtrip(tmp_path, schema, recs, writer, reader, **kw):
    path = str(tmp_path / f"{writer}-{reader}.avro")
    WRITERS[writer](path, schema, recs, **kw)
    got_schema, got = READERS[reader](path)
    assert got_schema == json.loads(json.dumps(schema))
    return got


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_training_records_cross_exactly(tmp_path, codec, writer, reader):
    recs = _training_records(50)
    assert _roundtrip(tmp_path, TRAINING_EXAMPLE_SCHEMA, recs, writer, reader, codec=codec) == recs


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_every_type_crosses_exactly_over_many_blocks(tmp_path, codec, writer, reader):
    recs = _all_types_records(230, seed=7)
    got = _roundtrip(tmp_path, ALL_TYPES_SCHEMA, recs, writer, reader, codec=codec, sync_interval=17)
    assert got == recs


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_negative_and_large_longs(tmp_path, writer, reader):
    schema = {"type": "record", "name": "R", "fields": [{"name": "v", "type": "long"}]}
    vals = [0, -1, 1, 63, -64, 64, -65, -(2**40), 2**40, 2**62, -(2**62), 2**63 - 1, -(2**63)]
    got = _roundtrip(tmp_path, schema, [{"v": v} for v in vals], writer, reader)
    assert [r["v"] for r in got] == vals


def test_same_records_encode_to_the_same_blocks(tmp_path):
    """The two writers differ only in the random sync marker."""
    recs = _all_types_records(40, seed=2)
    for codec in ("null", "deflate"):
        blobs = []
        for name, write in WRITERS.items():
            path = str(tmp_path / f"{name}-{codec}.avro")
            write(path, ALL_TYPES_SCHEMA, recs, codec=codec, sync_interval=9)
            raw = open(path, "rb").read()
            sync = raw[raw.index(b"\x00", raw.index(b"avro.codec")) + 1:][:16]
            blobs.append(raw.replace(sync, b"S" * 16))
        assert blobs[0] == blobs[1]


def test_model_and_result_schemas_are_the_reference_ones():
    from photon_ml_tpu.io import schemas as ref_schemas

    assert TRAINING_EXAMPLE_SCHEMA == REF_TRAINING_SCHEMA
    assert BAYESIAN_LINEAR_MODEL_SCHEMA == ref_schemas.BAYESIAN_LINEAR_MODEL_SCHEMA
    assert SCORING_RESULT_SCHEMA == ref_schemas.SCORING_RESULT_SCHEMA
    assert FEATURE_SUMMARIZATION_RESULT_SCHEMA == ref_schemas.FEATURE_SUMMARIZATION_RESULT_SCHEMA


@pytest.mark.parametrize("writer", list(WRITERS))
def test_corrupt_sync_detected(tmp_path, writer):
    path = str(tmp_path / "x.avro")
    schema = {"type": "record", "name": "R", "fields": [{"name": "v", "type": "long"}]}
    WRITERS[writer](path, schema, [{"v": 1}], codec="null")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF  # flip a sync byte
    open(path, "wb").write(raw)
    with pytest.raises(ValueError, match="sync"):
        port.read_avro_file(path)


def test_truncated_and_foreign_files_are_refused(tmp_path):
    path = str(tmp_path / "x.avro")
    schema = {"type": "record", "name": "R", "fields": [{"name": "s", "type": "string"}]}
    port.write_avro_file(path, schema, [{"s": "x" * 100}] * 3, codec="null")
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-30])
    with pytest.raises(EOFError):
        port.read_avro_file(path)
    open(path, "wb").write(b"PAR1" + raw[4:])
    with pytest.raises(ValueError, match="not an Avro container"):
        port.read_avro_file(path)
    with pytest.raises(ValueError, match="unsupported codec"):
        port.write_avro_file(path, schema, [], codec="snappy")


def test_schema_header_and_directories(tmp_path):
    schema = {"type": "record", "name": "R", "fields": [{"name": "v", "type": "long"}]}
    for p in range(3):
        ref.write_avro_file(str(tmp_path / f"part-{p}.avro"), schema, [{"v": p}, {"v": -p}])
    (tmp_path / ".hidden.avro").write_bytes(b"junk")
    (tmp_path / "notes.txt").write_text("not a part file")
    assert port.read_avro_schema(str(tmp_path / "part-0.avro")) == schema
    assert port.list_avro_files(str(tmp_path)) == ref.list_avro_files(str(tmp_path))
    assert list(port.iter_avro_directory(str(tmp_path))) == list(ref.iter_avro_directory(str(tmp_path)))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        port.list_avro_files(str(tmp_path / "empty"))


def test_unresolved_reference_and_union_without_branch(tmp_path):
    with pytest.raises(ValueError, match="unresolved"):
        port.write_avro_file(str(tmp_path / "a.avro"), {"type": "record", "name": "R",
                             "fields": [{"name": "x", "type": "Missing"}]}, [{"x": 1}])
    with pytest.raises(ValueError, match="no union branch"):
        port.write_avro_file(str(tmp_path / "b.avro"), {"type": "record", "name": "R",
                             "fields": [{"name": "x", "type": ["null"]}]}, [{"x": 1}])
