"""The port's native columnar Avro decoder (``native/avro_ingest.cc`` through
``io/native_ingest.py``), the default path of its ``AvroDataReader``: on the
same part files it must equal, bit for bit, the port's Python path and the
JAX package's default ``read(use_native=True)`` (index maps, entity maps,
labels, offsets, weights, uids and every shard's arrays), over null and
deflate codecs, several parts and blocks, frozen maps, ``extend_entities``,
a schema without offsets and weights, an empty part file and a sparse shard
wider than the dense threshold. A schema outside the envelope is read by the
Python codec with one log line naming the field; a failed build raises; the
drivers read natively by default."""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from photon_ml_tpu.config import FeatureShardConfig as JShard
from photon_ml_tpu.io.avro import read_avro_schema as ref_read_schema
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.native_ingest import compile_program as ref_compile
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.config import FeatureShardConfig
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.io import data_reader as port_reader_module
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.native_ingest import OutsideEnvelope, compile_program, decode_file
from photon_ml_tpu_torch.native import build

WIDE = 20_000  # the wide bag's key range: over 2048 distinct keys (the densify threshold)
SHARDS = {
    "global": dict(feature_bags=("features",), has_intercept=True),
    "per_user": dict(feature_bags=("userFeatures",), has_intercept=False),
    "mixed": dict(feature_bags=("userFeatures", "features"), has_intercept=True),
}
WIDE_SHARD = {"wide": dict(feature_bags=("wideFeatures",), has_intercept=True)}
TAGS = ("userId", "itemId")


def _schema(wide: bool, scalars: bool = True):
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    if not scalars:  # no offset or weight field at all
        schema["fields"] = [f for f in schema["fields"] if f["name"] not in ("offset", "weight")]
    at = [f["name"] for f in schema["fields"]].index("features") + 1
    for bag in ("userFeatures", *(("wideFeatures",) if wide else ())):
        schema["fields"].insert(at, {"name": bag, "type": {"type": "array", "items": "NameTermValueAvro"},
                                     "default": []})
    return schema


def _records(n: int, seed: int, wide: bool, scalars: bool = True, users: int = 9, uid0: int = 0):
    """float32-exact values; rows that miss features, repeated keys in a row
    (also across the two bags of the mixed shard), keys with and without
    terms, string and long uids and missing ones, null and set offsets and
    weights."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        v = rng.normal(size=16).astype(np.float32)
        feats = [{"name": "g", "term": str(j), "value": float(v[j])} for j in range(4) if rng.uniform() < 0.8]
        if i % 7 == 3:
            feats.append({"name": "g", "term": "0", "value": float(v[5])})
        if i % 5 == 1:
            feats.append({"name": "u", "term": "1", "value": float(v[4])})  # also a userFeatures key
        feats.append({"name": f"age{i % 3}", "term": "", "value": float(v[6])})
        rec = {
            "uid": None if i % 11 == 5 else (uid0 + i if i % 2 else f"r{uid0 + i}"),
            "response": float(rng.integers(0, 2)),
            "features": feats,
            "userFeatures": [{"name": "u", "term": str(j), "value": float(v[14 + j])} for j in range(2)],
            "metadataMap": {"userId": f"user_{int(rng.integers(0, users))}", "itemId": f"item_{i % 4}",
                            "other": "x"},
        }
        if scalars:
            rec["offset"] = None if i % 3 else float(v[12])
            rec["weight"] = None if i % 4 else float(abs(v[13]) + 0.5)
        if wide:
            k = 6 + i % 6
            rec["wideFeatures"] = [{"name": "w", "term": str(int(t)), "value": float(x)} for t, x in
                                   zip(rng.integers(0, WIDE, size=k), rng.normal(size=k).astype(np.float32))]
        recs.append(rec)
    return recs


# case -> (codec, records per block, wide shard, offset/weight fields, an empty part)
CASES = {
    "null_codec_blocks": ("null", 37, False, True, False),
    "deflate_blocks": ("deflate", 50, False, True, False),
    "no_offsets_weights": ("deflate", 4000, False, False, False),
    "empty_part": ("deflate", 64, False, True, True),
    "wide_sparse_shard": ("null", 100, True, True, False),
}


def _readers(wide: bool):
    shards = {**SHARDS, **(WIDE_SHARD if wide else {})}
    return (AvroDataReader({s: FeatureShardConfig(**c) for s, c in shards.items()}),
            JReader({s: JShard(**c) for s, c in shards.items()}))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    codec, block, wide, scalars, empty = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    schema = _schema(wide, scalars)
    os.makedirs(root / "train")
    parts = [_records(230, 1, wide, scalars), _records(170, 2, wide, scalars, uid0=1000)]
    if empty:
        parts.insert(1, [])
    for p, recs in enumerate(parts):
        write_avro_file(str(root / "train" / f"part-{p:05d}.avro"), schema, recs, codec=codec,
                        sync_interval=block)
    val = _records(120, 3, wide, scalars, users=14, uid0=5000)
    val[0]["features"].append({"name": "unseen", "term": "x", "value": 2.0})
    write_avro_file(str(root / "val.avro"), schema, val, codec=codec, sync_interval=block)
    return dict(root=root, wide=wide)


def _same(a, b):
    """Two datasets (either package's) equal bit for bit."""
    assert set(a.index_maps) == set(b.index_maps)
    for sid, imap in a.index_maps.items():
        assert list(imap.items()) == list(b.index_maps[sid].items())
    assert a.entity_maps == b.entity_maps
    assert a.uids == b.uids
    np.testing.assert_array_equal(a.labels, b.labels)
    for col in ("labels", "offsets", "weights"):
        got, want = np.asarray(getattr(a.batch, col)), np.asarray(getattr(b.batch, col))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert set(a.batch.id_tags) == set(b.batch.id_tags)
    for t in a.batch.id_tags:
        np.testing.assert_array_equal(np.asarray(a.batch.id_tags[t]), np.asarray(b.batch.id_tags[t]))
    for sid, fa in a.batch.features.items():
        fb = b.batch.features[sid]
        assert type(fa).__name__ == type(fb).__name__
        if hasattr(fa, "X"):
            np.testing.assert_array_equal(np.asarray(fa.X), np.asarray(fb.X))
        else:
            assert fa.num_features == fb.num_features
            np.testing.assert_array_equal(np.asarray(fa.indices), np.asarray(fb.indices))
            np.testing.assert_array_equal(np.asarray(fa.values), np.asarray(fb.values))


def _three_reads(case, path, **kw):
    """(port native, port Python, reference native) reads of ``path``; the
    maps in ``kw`` are given in each package's own types."""
    port, ref = _readers(case["wide"])
    port_kw = {k: v[0] for k, v in kw.items()}
    ref_kw = {k: v[1] for k, v in kw.items()}
    nat = port.read(path, id_tags=TAGS, device="cpu", **port_kw)
    py = port.read(path, id_tags=TAGS, device="cpu", use_native=False, **port_kw)
    want = ref.read(path, id_tags=TAGS, use_native=True, **ref_kw)
    assert nat.decoder == "native" and py.decoder == "python"
    return nat, py, want


@pytest.fixture(scope="module")
def train_reads(case):
    return _three_reads(case, str(case["root"] / "train"))


def test_training_read_equals_python_path_and_reference(train_reads, case):
    nat, py, want = train_reads
    _same(nat, py)
    _same(nat, want)
    assert nat.batch.num_rows == 400
    if case["wide"]:
        assert type(nat.batch.features["wide"]).__name__ == "SparseFeatures"
        assert nat.index_maps["wide"].size > 2048
    # the mixed shard's first-seen order interleaves its two bags row by row
    assert nat.index_maps["mixed"].keys_for([0, 1]) == ["u\x010", "u\x011"]


def test_validation_read_against_frozen_maps(train_reads, case):
    nat_t, _, want_t = train_reads
    maps = dict(index_maps=(nat_t.index_maps, want_t.index_maps),
                entity_maps=(nat_t.entity_maps, want_t.entity_maps))
    nat, py, want = _three_reads(case, str(case["root"] / "val.avro"), **maps)
    _same(nat, py)
    _same(nat, want)
    assert (nat.batch.id_tags["userId"].numpy() == -1).any()
    assert nat.entity_maps == nat_t.entity_maps
    assert "unseen\x01x" not in nat.index_maps["global"]


def test_extend_entities(train_reads, case):
    nat_t, _, want_t = train_reads
    nat, py, want = _three_reads(case, str(case["root"] / "val.avro"),
                                 entity_maps=(nat_t.entity_maps, want_t.entity_maps),
                                 extend_entities=(True, True))
    _same(nat, py)
    _same(nat, want)
    assert nat.batch.id_tags["userId"].numpy().min() >= 0


def _nullable_response_schema():
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"][1]["type"] = ["null", "double"]
    schema["fields"][1]["default"] = None
    return schema


def test_nullable_response_reads_with_the_python_codec(tmp_path, caplog):
    """The decoder would put 0 where a label is null; the file set goes
    through the Python codec (which raises on a null label), as in the
    reference, with one log line naming the field."""
    path = str(tmp_path / "nullable.avro")
    recs = [{"uid": None, "response": 1.0, "offset": None, "weight": None,
             "features": [{"name": "a", "term": "", "value": 1.0}], "metadataMap": None}]
    write_avro_file(path, _nullable_response_schema(), recs)
    with caplog.at_level(logging.WARNING, logger=port_reader_module.__name__):
        ds = AvroDataReader().read(path, device="cpu")
    assert ds.decoder == "python"
    lines = [r.getMessage() for r in caplog.records if r.name == port_reader_module.__name__]
    assert len(lines) == 1 and "'response'" in lines[0] and "Python codec" in lines[0]
    _same(ds, JReader().read(path, use_native=True))
    write_avro_file(path, _nullable_response_schema(), [dict(recs[0], response=None)])
    with pytest.raises(TypeError):
        AvroDataReader().read(path, device="cpu")


def test_unsupported_schema_reads_with_the_python_codec(tmp_path, caplog):
    """A bag item with a fourth field is outside the envelope (the
    reference's test_unsupported_schema_falls_back): the Python codec reads
    it, and the reader says so."""
    schema = {
        "type": "record", "name": "Weird",
        "fields": [
            {"name": "response", "type": "double"},
            {"name": "features", "type": {"type": "array", "items": {
                "type": "record", "name": "NTV4", "fields": [
                    {"name": "name", "type": "string"},
                    {"name": "term", "type": "string"},
                    {"name": "value", "type": "double"},
                    {"name": "extra", "type": "long"},
                ]}}},
        ],
    }
    path = str(tmp_path / "w.avro")
    write_avro_file(path, schema, [{"response": 1.0, "features": [
        {"name": "a", "term": "", "value": 2.0, "extra": 1}]}])
    shards = {"global": FeatureShardConfig(feature_bags=("features",), has_intercept=False)}
    with caplog.at_level(logging.WARNING, logger=port_reader_module.__name__):
        ds = AvroDataReader(shards).read(path, device="cpu")
    assert ds.decoder == "python" and ds.batch.num_rows == 1 and ds.index_maps["global"].get("a") >= 0
    assert any("'features'" in r.getMessage() for r in caplog.records)
    _same(ds, JReader({"global": JShard(feature_bags=("features",), has_intercept=False)}).read(path))


@pytest.mark.parametrize("schema_name", ["training", "no_scalars_wide", "nullable_response", "ntv4",
                                         "float_values", "reordered_ntv", "bag_missing"])
def test_compile_program_matches_the_reference(schema_name):
    """The same opcode program as the reference's for every schema it
    compiles; where it returns None, the port raises ``OutsideEnvelope``."""
    bags = ["features", "userFeatures"]
    schema = {"training": _schema(False), "no_scalars_wide": _schema(True, scalars=False),
              "nullable_response": _nullable_response_schema()}.get(schema_name)
    if schema is None:
        schema = _schema(False)
        items = json.loads(json.dumps(schema["fields"][4]["type"]["items"]))
        if schema_name == "ntv4":
            items["fields"].append({"name": "extra", "type": "long"})
        elif schema_name == "float_values":
            items["fields"][2]["type"] = "float"
        elif schema_name == "reordered_ntv":
            items["fields"] = items["fields"][::-1]
        else:
            bags = ["features", "absentFeatures"]
        schema["fields"][4]["type"]["items"] = items
    args = (bags, {"response": 0.0, "offset": 0.0, "weight": 1.0}, "metadataMap", "uid")
    kw = dict(non_nullable=frozenset({"response"}))
    want = ref_compile(json.loads(json.dumps(schema)), *args, **kw)
    if want is None:
        with pytest.raises(OutsideEnvelope):
            compile_program(schema, *args, **kw)
        return
    got = compile_program(schema, *args, **kw)
    np.testing.assert_array_equal(got.ops, want.ops)
    np.testing.assert_array_equal(got.defaults, want.defaults)
    assert (got.slots, got.bags, got.capture_uid) == (want.slots, want.bags, want.capture_uid)


def test_corrupt_file_raises_not_falls_back(tmp_path):
    path = tmp_path / "c.avro"
    write_avro_file(str(path), _schema(False), _records(50, 1, False), codec="null", sync_interval=10)
    data = bytearray(path.read_bytes())
    data[-5] ^= 0xFF  # the last sync marker
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="sync marker mismatch"):
        AvroDataReader().read(str(path), device="cpu")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No silent fallback: a build that fails raises, and so does the read."""
    monkeypatch.setenv("PHOTON_ML_TPU_CACHE", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-DPHOTON_BROKEN", "-include", "no_such_header.h"))
    path = str(tmp_path / "one.avro")
    write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, [{"uid": None, "response": 1.0, "offset": None,
                                                     "weight": None, "features": [], "metadataMap": None}])
    with pytest.raises(RuntimeError, match="no_such_header"):
        build.build()
    with pytest.raises(RuntimeError, match="building the native library failed"):
        AvroDataReader().read(path, device="cpu")
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        build.build()


def test_the_library_builds_from_the_ports_own_source(monkeypatch, tmp_path):
    """The port's sources (the index store and the decoder, one library as
    in the reference), built where the reference builds its library:
    under ``PHOTON_ML_TPU_CACHE``, else under the temporary directory."""
    assert [s.relative_to(build._PKG.parent).as_posix() for s in build.SOURCES] == [
        "photon_ml_tpu_torch/native/index_store.cc", "photon_ml_tpu_torch/native/avro_ingest.cc"]
    monkeypatch.delenv("PHOTON_ML_TPU_CACHE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert build.library_path().parent == tmp_path / "photon_ml_tpu_torch_native"
    monkeypatch.setenv("PHOTON_ML_TPU_CACHE", "")  # empty: unset, as in the reference
    assert build.library_path().parent == tmp_path / "photon_ml_tpu_torch_native"
    assert build.library_path().name.startswith("libphoton_native_")


def _package_files() -> set[str]:
    return {os.path.relpath(os.path.join(d, f), build._PKG) for d, _, fs in os.walk(build._PKG) for f in fs
            if "__pycache__" not in d}


def test_the_cache_knob_takes_the_build_out_of_the_package(monkeypatch, tmp_path):
    """``PHOTON_ML_TPU_CACHE`` set: the library is compiled under it and
    loads from there, and not one file is added to the package."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("PHOTON_ML_TPU_CACHE", str(cache))
    before = _package_files()
    out = build.build()
    assert out.parent == cache and out.exists() and out.name.startswith("libphoton_native_")
    assert [p.name for p in cache.iterdir()] == [out.name]  # the temporary name was renamed away
    assert _package_files() == before
    assert build.build() == out  # built once: the second call finds it


def test_the_cache_knob_builds_from_a_read_only_package(tmp_path):
    """A copy of the native package made read-only, as an installed one may
    be: with the knob set, a fresh interpreter builds and loads the library
    from it into the cache, and the package's directory keeps its files."""
    pkg = tmp_path / "site" / "photon_ml_tpu_torch"
    shutil.copytree(build._PKG / "native", pkg / "native", ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").write_text("")
    for d in (pkg / "native", pkg):
        os.chmod(d, 0o555)
    listing = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*"))
    cache = tmp_path / "cache"
    script = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from photon_ml_tpu_torch.native import build; print(build.load() is not None, build.library_path())")
    try:
        env = dict(os.environ, PHOTON_ML_TPU_CACHE=str(cache), PYTHONDONTWRITEBYTECODE="1")
        proc = subprocess.run([sys.executable, "-c", script, str(tmp_path / "site")], capture_output=True, text=True,
                              env=env, timeout=120)
    finally:
        for d in (pkg, pkg / "native"):
            os.chmod(d, 0o755)
    assert proc.returncode == 0, proc.stderr
    loaded, path = proc.stdout.split()
    assert loaded == "True" and os.path.dirname(path) == str(cache) and os.path.exists(path)
    assert sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*")) == listing


def test_decode_file_columns(tmp_path):
    """One file's columns: numeric slots, a bag's CSR with its first-seen
    key table, tag ids (-1 where the record lacks the tag) and uids."""
    recs = _records(30, 5, False)
    recs[4]["metadataMap"] = None
    path = str(tmp_path / "f.avro")
    write_avro_file(path, _schema(False), recs, sync_interval=7)
    prog = compile_program(ref_read_schema(path), ["features"], {"response": 0.0, "weight": 1.0},
                           "metadataMap", "uid")
    col = decode_file(path, prog, ["userId"])
    assert col.num_rows == 30
    np.testing.assert_array_equal(col.numeric["response"], [r["response"] for r in recs])
    np.testing.assert_array_equal(col.numeric["weight"], [1.0 if r["weight"] is None else r["weight"]
                                                          for r in recs])
    bag = col.bags["features"]
    keys = [f"{f['name']}\x01{f['term']}" if f["term"] else f["name"] for r in recs for f in r["features"]]
    assert bag["uniq_keys"] == list(dict.fromkeys(keys))
    assert [bag["uniq_keys"][i] for i in bag["ids"]] == keys
    np.testing.assert_array_equal(np.diff(bag["rowptr"]), [len(r["features"]) for r in recs])
    tag = col.tags["userId"]
    assert tag["ids"][4] == -1
    assert [tag["uniq_values"][i] for i in np.delete(tag["ids"], 4)] == \
        [r["metadataMap"]["userId"] for i, r in enumerate(recs) if i != 4]
    assert col.uids == [r["uid"] for r in recs]


def test_intercept_without_its_key_three_ways(tmp_path):
    """A has-intercept shard over an index map without the intercept key
    (ROADMAP queue 3): both of the port's paths raise ValueError, as the
    reference's default native path raises; only the reference's fallback
    Python path adds 1 to every column of the row."""
    path = str(tmp_path / "i.avro")
    write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, [
        {"uid": None, "response": 1.0, "offset": None, "weight": None,
         "features": [{"name": "a", "term": "", "value": 2.0}], "metadataMap": None}])
    maps = {"global": IndexMap.build(["a", "b"])}
    for use_native in (True, False):
        with pytest.raises(ValueError, match="no intercept key"):
            AvroDataReader().read(path, index_maps=maps, device="cpu", use_native=use_native)
    from photon_ml_tpu.data.index_map import IndexMap as JIndexMap

    jmaps = {"global": JIndexMap.build(["a", "b"])}
    with pytest.raises(TypeError):
        JReader().read(path, index_maps=jmaps, use_native=True)
    X = np.asarray(JReader().read(path, index_maps=jmaps, use_native=False).batch.features["global"].X)
    np.testing.assert_array_equal(X, [[3.0, 1.0]])


def _record_decoders(monkeypatch):
    seen = []
    read = AvroDataReader.read

    def recorded(self, *args, **kwargs):
        ds = read(self, *args, **kwargs)
        seen.append(ds.decoder)
        return ds

    monkeypatch.setattr(AvroDataReader, "read", recorded)
    return seen


def test_drivers_read_natively_by_default(tmp_path, monkeypatch):
    from photon_ml_tpu_torch.cli import score as port_score
    from photon_ml_tpu_torch.cli import train as port_train
    from photon_ml_tpu_torch.cli import train_glm as port_glm
    from photon_ml_tpu_torch.config import parse_config

    os.makedirs(tmp_path / "train")
    write_avro_file(str(tmp_path / "train" / "part-0.avro"), _schema(False), _records(120, 1, False))
    write_avro_file(str(tmp_path / "val.avro"), _schema(False), _records(40, 2, False))
    config = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinate_update_sequence": ["fixed", "per_user"],
        "coordinate_descent_iterations": 1,
        "fixed_effect_coordinates": {"fixed": {"feature_shard_id": "global", "optimization": {
            "optimizer": {"max_iterations": 5}}}},
        "random_effect_coordinates": {"per_user": {
            "random_effect_type": "userId", "feature_shard_id": "per_user",
            "optimization": {"optimizer": {"max_iterations": 5}, "regularization_weight": 1.0}}},
        "feature_shards": {"global": {"feature_bags": ["features"], "has_intercept": True},
                           "per_user": {"feature_bags": ["userFeatures"], "has_intercept": False}},
    }
    seen = _record_decoders(monkeypatch)
    from photon_ml_tpu_torch.utils import PhotonLogger

    quiet = PhotonLogger(None, stream=io.StringIO())
    port_train.run(parse_config(config), [str(tmp_path / "train")], str(tmp_path / "out"),
                   validation_data=[str(tmp_path / "val.avro")], logger=quiet, device="cpu")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    port_score.main(["--model-dir", str(tmp_path / "out"), "--data", str(tmp_path / "val.avro"),
                     "--output-dir", str(tmp_path / "scores"), "--config", str(cfg_path), "--device", "cpu"])
    port_glm.run(port_glm.TaskType.LOGISTIC_REGRESSION, [str(tmp_path / "train")], str(tmp_path / "glm"),
                 data_format="avro", validation_data=[str(tmp_path / "val.avro")], max_iterations=5,
                 device="cpu", logger=quiet)
    assert seen == ["native"] * 5
