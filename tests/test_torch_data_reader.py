"""The port's ``AvroDataReader`` (its default, native path) against the JAX
package's reader on both of its paths (``use_native=False`` and its default
``use_native=True``) on the same Avro part files: index maps, entity maps,
labels, offsets, weights, uids, entity ids and every shard's arrays (dense,
and padded sparse for a shard wider than 2048) must be equal bit for bit;
validation reads against frozen maps, ``extend_entities`` and prebuilt maps
saved by the other package must agree too."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.config import FeatureShardConfig as JShard
from photon_ml_tpu.data.index_map import IndexMap as JIndexMap
from photon_ml_tpu.io.avro import write_avro_file as ref_write
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import expand_date_range as ref_expand
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.config import FeatureShardConfig
from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap, feature_key
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, expand_date_range

WIDE = 3000  # distinct keys of the wide bag: above the 2048 densify threshold


def _schema():
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    for bag in ("wideFeatures", "userFeatures"):
        schema["fields"].insert(5, {"name": bag, "type": {"type": "array", "items": "NameTermValueAvro"},
                                    "default": []})
    return schema


def _records(n: int, seed: int, users: int = 9, uid_offset: int = 0) -> list[dict]:
    """float32-exact values; rows that miss features, a duplicated key in a
    row, keys with and without terms, null and set offsets / weights."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        vals = rng.normal(size=16).astype(np.float32)
        feats = [{"name": "g", "term": str(j), "value": float(vals[j])} for j in range(4) if rng.uniform() < 0.8]
        if i % 7 == 3:
            feats.append({"name": "g", "term": "0", "value": float(vals[5])})  # repeated in the row
        feats.append({"name": f"age{i % 3}", "term": "", "value": float(vals[6])})
        wide = [
            {"name": "w", "term": str(int(t)), "value": float(v)}
            for t, v in zip(rng.integers(0, WIDE, size=1 + i % 5), vals[7:12])
        ]
        recs.append({
            "uid": f"r{uid_offset + i}",
            "response": float(rng.integers(0, 2)),
            "offset": None if i % 3 else float(vals[12]),
            "weight": None if i % 4 else float(abs(vals[13]) + 0.5),
            "features": feats,
            "userFeatures": [{"name": "u", "term": str(j), "value": float(vals[14 + j])} for j in range(2)],
            "wideFeatures": wide,
            "metadataMap": {"userId": f"user_{int(rng.integers(0, users))}", "itemId": f"item_{i % 4}"},
        })
    return recs


SHARDS = {
    "global": dict(feature_bags=("features",), has_intercept=True),
    "per_user": dict(feature_bags=("userFeatures",), has_intercept=False),
    "mixed": dict(feature_bags=("userFeatures", "features"), has_intercept=True),
    "wide": dict(feature_bags=("wideFeatures",), has_intercept=True),
}
TAGS = ("userId", "itemId")


def _readers():
    return (
        AvroDataReader({s: FeatureShardConfig(**c) for s, c in SHARDS.items()}),
        JReader({s: JShard(**c) for s, c in SHARDS.items()}),
    )


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("avro")
    # the training parts, written by each package; the validation part holds
    # users and features the training data never saw
    os.makedirs(root / "train")
    write_avro_file(str(root / "train" / "part-00000.avro"), _schema(), _records(1200, seed=1))
    ref_write(str(root / "train" / "part-00001.avro"), _schema(), _records(600, seed=2), sync_interval=100)
    val = _records(300, seed=3, users=14, uid_offset=10_000)
    val[0]["features"].append({"name": "unseen", "term": "x", "value": 2.0})
    write_avro_file(str(root / "val.avro"), _schema(), val)
    return root


def _assert_same(port_ds, ref_ds):
    assert set(port_ds.index_maps) == set(ref_ds.index_maps)
    for sid, imap in port_ds.index_maps.items():
        assert list(imap.items()) == list(ref_ds.index_maps[sid].items())
        assert imap.intercept_index == ref_ds.index_maps[sid].intercept_index
    assert port_ds.entity_maps == ref_ds.entity_maps
    assert port_ds.uids == ref_ds.uids
    pb, rb = port_ds.batch, ref_ds.batch
    for col in ("labels", "offsets", "weights"):
        got, want = getattr(pb, col).numpy(), np.asarray(getattr(rb, col))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_ds.labels, ref_ds.labels)
    assert set(pb.id_tags) == set(rb.id_tags)
    for t in pb.id_tags:
        np.testing.assert_array_equal(pb.id_tags[t].numpy(), np.asarray(rb.id_tags[t]))
    for sid, feats in pb.features.items():
        want = rb.features[sid]
        assert type(feats).__name__ == type(want).__name__
        if hasattr(want, "X"):
            np.testing.assert_array_equal(feats.X.numpy(), np.asarray(want.X))
        else:
            assert feats.num_features == want.num_features
            np.testing.assert_array_equal(feats.indices.numpy(), np.asarray(want.indices))
            np.testing.assert_array_equal(feats.values.numpy(), np.asarray(want.values))


@pytest.fixture(scope="module", params=[False, True], ids=["ref_python", "ref_native"])
def ref_native(request):
    """The reference reader's path: its Python codec, or its default native one."""
    return request.param


@pytest.fixture(scope="module")
def train_read(data_dir, ref_native):
    port_reader, ref_reader = _readers()
    path = str(data_dir / "train")
    port_ds = port_reader.read(path, id_tags=TAGS, device="cpu")
    assert port_ds.decoder == "native"
    return port_ds, ref_reader.read(path, id_tags=TAGS, use_native=ref_native)


def test_training_read_is_bitwise_the_reference(train_read):
    port_ds, ref_ds = train_read
    _assert_same(port_ds, ref_ds)
    assert port_ds.batch.num_rows == 1800
    assert port_ds.index_maps["wide"].size > 2048  # the sparse container
    assert port_ds.intercept_indices == ref_ds.intercept_indices
    assert port_ds.entity_names() == ref_ds.entity_names()


def test_validation_read_against_frozen_maps(data_dir, train_read, ref_native):
    port_train, ref_train = train_read
    port_reader, ref_reader = _readers()
    path = str(data_dir / "val.avro")
    port_ds = port_reader.read(path, id_tags=TAGS, index_maps=port_train.index_maps,
                               entity_maps=port_train.entity_maps, device="cpu")
    ref_ds = ref_reader.read(path, id_tags=TAGS, index_maps=ref_train.index_maps,
                             entity_maps=ref_train.entity_maps, use_native=ref_native)
    _assert_same(port_ds, ref_ds)
    users = port_ds.batch.id_tags["userId"].numpy()
    assert (users == -1).any() and (users >= 0).any()  # unseen users stay -1
    assert port_ds.entity_maps == port_train.entity_maps  # frozen
    assert "unseen\x01x" not in port_ds.index_maps["global"]


def test_extend_entities_appends_after_the_known_ones(data_dir, train_read, ref_native):
    port_train, ref_train = train_read
    port_reader, ref_reader = _readers()
    path = str(data_dir / "val.avro")
    port_ds = port_reader.read(path, id_tags=TAGS, entity_maps=port_train.entity_maps,
                               extend_entities=True, device="cpu")
    ref_ds = ref_reader.read(path, id_tags=TAGS, entity_maps=ref_train.entity_maps,
                             extend_entities=True, use_native=ref_native)
    _assert_same(port_ds, ref_ds)
    known = len(port_train.entity_maps["userId"])
    users = port_ds.batch.id_tags["userId"].numpy()
    assert users.min() >= 0 and users.max() >= known


@pytest.mark.parametrize("saved_by", ["port", "ref"])
def test_prebuilt_maps_saved_by_either_package(tmp_path, data_dir, train_read, saved_by, ref_native):
    port_train, ref_train = train_read
    maps = port_train.index_maps if saved_by == "port" else ref_train.index_maps
    for sid, m in maps.items():
        m.save(str(tmp_path / sid))
    port_maps = {sid: IndexMap.load(str(tmp_path / f"{sid}.npz")) for sid in SHARDS}
    ref_maps = {sid: JIndexMap.load(str(tmp_path / sid)) for sid in SHARDS}
    port_reader, ref_reader = _readers()
    path = str(data_dir / "val.avro")
    _assert_same(
        port_reader.read(path, id_tags=TAGS, index_maps=port_maps, device="cpu"),
        ref_reader.read(path, id_tags=TAGS, index_maps=ref_maps, use_native=ref_native),
    )


def test_index_map_matches_the_reference():
    keys = ["b", feature_key("a", "x"), "(INTERCEPT)", "b", feature_key("a", "")]
    port_map, ref_map = IndexMap.build(keys, add_intercept=True), JIndexMap.build(keys, add_intercept=True)
    assert list(port_map.items()) == list(ref_map.items())
    assert port_map.intercept_index == ref_map.intercept_index == 3
    queries = np.array(["a\x01x", "zz", "b", "a\x01xlonger"])
    np.testing.assert_array_equal(port_map.lookup_all(queries), ref_map.lookup_all(queries))
    assert port_map.keys_for([0, 2, 9]) == ref_map.keys_for([0, 2, 9])
    assert DELIMITER == "\x01" and feature_key("n", "t") == "n\x01t"
    assert port_map.get("missing") == -1 and "b" in port_map and len(port_map) == 4


def test_build_index_maps_and_missing_tag(data_dir):
    port_reader, ref_reader = _readers()
    recs = _records(50, seed=9)
    got, want = port_reader.build_index_maps(recs), ref_reader.build_index_maps(recs)
    assert {s: list(m.items()) for s, m in got.items()} == {s: list(m.items()) for s, m in want.items()}
    bad = _records(3, seed=4)
    del bad[1]["metadataMap"]["itemId"]
    path = str(data_dir / "missing-tag.avro")
    write_avro_file(path, _schema(), bad)
    with pytest.raises(ValueError, match="record 1 missing id tag 'itemId'"):
        port_reader.read(path, id_tags=TAGS, device="cpu")


def test_default_shard_and_no_uids(tmp_path):
    recs = [{"uid": None, "response": 1.0, "offset": None, "weight": None,
             "features": [{"name": "x", "term": "", "value": 0.5}], "metadataMap": None}]
    path = str(tmp_path / "one.avro")
    write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, recs)
    ds = AvroDataReader().read(path, device="cpu")
    assert ds.uids is None and list(ds.index_maps) == ["global"]
    np.testing.assert_array_equal(ds.batch.features["global"].X.numpy(), [[0.5, 1.0]])
    with pytest.raises(ValueError, match="no feature bags"):
        AvroDataReader({"s": FeatureShardConfig(feature_bags=())})


def test_read_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    recs = [{"uid": None, "response": 1.0, "features": [], "metadataMap": None}]
    path = str(tmp_path / "one.avro")
    write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, recs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AvroDataReader().read(path)
    assert AvroDataReader().read(path, device="cpu").batch.device.type == "cpu"


def test_expand_date_range_matches_the_reference(tmp_path):
    for d in ("daily/2024/01/30", "daily/2024/02/01", "2024-01-31"):
        os.makedirs(tmp_path / d)
    base = str(tmp_path)
    assert expand_date_range(base, "2024-01-29", "2024-02-02") == ref_expand(base, "2024-01-29", "2024-02-02")
    assert len(expand_date_range(base, "2024-01-29", "2024-02-02")) == 3
    with pytest.raises(FileNotFoundError):
        expand_date_range(base, "2023-01-01", "2023-01-02")
    with pytest.raises(ValueError, match="precedes"):
        expand_date_range(base, "2024-02-02", "2024-01-29")
