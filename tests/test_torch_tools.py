"""The port's tools (``photon_ml_tpu_torch/native/index_store``,
``cli/name_term_bags``, ``cli/index_features``, ``cli/main``) on the CPU,
held to the JAX package's.

- The native index store: the reference's ``tests/test_native.py`` cases
  run against the port's ``NativeIndexStore``; a store either package
  builds from the same items is the same file byte for byte, and each
  package opens the other's; a failed library build raises (no stand-in).
- The tools: ``name_term_bags`` and ``index_features`` write the
  reference's bytes (bag JSON, ``_sizes.json``) and key → index maps on
  the fixture of ``tests/test_drivers.py``'s indexing tests; the port's
  GAME driver trained with ``--index-maps`` is bitwise the one without.
- The umbrella ``photon-ml-tpu-torch``: dispatch, usage and unknown-command
  exit codes, and ``serve``'s refusal.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch
import pytest

from photon_ml_tpu.cli import index_features as ref_index_features
from photon_ml_tpu.cli import name_term_bags as ref_name_term_bags
from photon_ml_tpu.data.index_map import IndexMap as RefIndexMap
from photon_ml_tpu.data.synthetic import synthetic_game_data
from photon_ml_tpu.io.avro import write_avro_file as ref_write
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.native import NativeIndexStore as RefStore
from photon_ml_tpu.utils import PhotonLogger as RefLogger
from photon_ml_tpu_torch.cli import index_features, name_term_bags
from photon_ml_tpu_torch.cli import main as umbrella
from photon_ml_tpu_torch.cli import train as port_train
from photon_ml_tpu_torch.config import parse_config
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.native import NativeIndexStore
from photon_ml_tpu_torch.native import index_store as port_index_store
from photon_ml_tpu_torch.utils import PhotonLogger


@pytest.fixture
def store_path(tmp_path):
    return str(tmp_path / "features.pidx")


# ---------------------------------------------------------------------------
# (i) the native index store: the reference's cases on the port
# ---------------------------------------------------------------------------
class TestNativeIndexStore:
    def test_build_get_missing(self, store_path):
        s = NativeIndexStore.build(store_path, [("alpha", 0), ("beta", 1), ("g\x01us", 2)])
        assert s.size == 3 and len(s) == 3
        assert s.get("alpha") == 0
        assert s.get("g\x01us") == 2
        assert s.get("nope") == -1
        assert "beta" in s and "nope" not in s

    def test_bulk_lookup(self, store_path):
        n = 5000
        items = [(f"feat_{i}\x01term_{i % 7}", i) for i in range(n)]
        s = NativeIndexStore.build(store_path, items)
        keys = [k for k, _ in items] + ["missing_1", "missing_2"]
        out = s.lookup_all(keys)
        np.testing.assert_array_equal(out[:n], np.arange(n))
        np.testing.assert_array_equal(out[n:], [-1, -1])

    def test_persistence_across_handles(self, store_path):
        NativeIndexStore.build(store_path, [("x", 7)]).close()
        s2 = NativeIndexStore(store_path)
        assert s2.get("x") == 7

    def test_items_roundtrip(self, store_path):
        items = {f"k{i}": i for i in range(100)}
        s = NativeIndexStore.build(store_path, items.items())
        assert dict(s.items()) == items

    def test_duplicate_key_rejected(self, store_path):
        with pytest.raises(ValueError, match="duplicate"):
            NativeIndexStore.build(store_path, [("a", 0), ("a", 1)])

    def test_parity_with_python_index_map(self, store_path):
        rng = np.random.default_rng(42)
        keys = [f"name_{i}\x01term_{rng.integers(0, 5)}" for i in range(1000)]
        imap = IndexMap.build(keys, add_intercept=True)
        s = NativeIndexStore.build(store_path, imap.items())
        assert s.size == imap.size
        queries = np.array(keys[::7] + ["zzz_unknown"])
        np.testing.assert_array_equal(s.lookup_all(queries), imap.lookup_all(queries))

    def test_empty_store(self, store_path):
        s = NativeIndexStore.build(store_path, [])
        assert s.size == 0
        assert s.get("anything") == -1
        assert s.lookup_all([]).shape == (0,)

    def test_unicode_keys(self, store_path):
        s = NativeIndexStore.build(store_path, [("héllo", 1), ("日本語", 2)])
        assert s.get("héllo") == 1
        assert s.get("日本語") == 2

    def test_open_refuses_a_foreign_file(self, tmp_path):
        path = tmp_path / "not-a-store"
        path.write_bytes(b"NOTPIDX" + bytes(64))
        with pytest.raises(OSError, match="cannot open index store"):
            NativeIndexStore(str(path))

    def test_a_failed_build_raises_and_nothing_stands_in(self, store_path, monkeypatch):
        def no_compiler():
            raise RuntimeError("building the native library failed (g++ exit 1)")

        monkeypatch.setattr(port_index_store, "load", no_compiler)
        with pytest.raises(RuntimeError, match="building the native library failed"):
            NativeIndexStore.build(store_path, [("a", 0)])
        with pytest.raises(RuntimeError, match="building the native library failed"):
            NativeIndexStore(store_path)


def _items(seed: int, n: int) -> list[tuple[str, int]]:
    """Feature keys as the readers make them (name \\x01 term), unicode
    ones among them, with shuffled values."""
    rng = np.random.default_rng(seed)
    keys = [f"n{rng.integers(0, 50)}_{i}\x01t{rng.integers(0, 9)}" for i in range(n)]
    keys += ["héllo\x01wörld", "日本語\x01", "\x01"]
    return list(zip(keys, rng.permutation(len(keys)).tolist()))


@pytest.mark.parametrize("n", [0, 1, 3, 1000, 20_000])
def test_store_files_are_byte_identical_across_packages(tmp_path, n):
    items = _items(n, n) if n else []
    port = NativeIndexStore.build(str(tmp_path / "port.pidx"), items)
    ref = RefStore.build(str(tmp_path / "ref.pidx"), items)
    assert (tmp_path / "port.pidx").read_bytes() == (tmp_path / "ref.pidx").read_bytes()
    assert port.size == ref.size == len(items)


def test_each_package_opens_the_others_store(tmp_path):
    items = _items(7, 3000)
    NativeIndexStore.build(str(tmp_path / "port.pidx"), items).close()
    RefStore.build(str(tmp_path / "ref.pidx"), items).close()
    keys = [k for k, _ in items] + ["unknown\x01key"]
    expect = np.asarray([v for _, v in items] + [-1])
    from_ref = NativeIndexStore(str(tmp_path / "ref.pidx"))
    from_port = RefStore(str(tmp_path / "port.pidx"))
    np.testing.assert_array_equal(from_ref.lookup_all(keys), expect)
    np.testing.assert_array_equal(from_port.lookup_all(keys), expect)
    assert dict(from_ref.items()) == dict(from_port.items()) == dict(items)
    assert from_ref.get("héllo\x01wörld") == from_port.get("héllo\x01wörld") == dict(items)["héllo\x01wörld"]


def test_index_map_items_agree_with_the_references(tmp_path):
    """The store built from the port's ``IndexMap`` is the store built
    from the reference's ``IndexMap`` over the same keys."""
    keys = [k for k, _ in _items(3, 500)]
    NativeIndexStore.build(str(tmp_path / "port.pidx"), IndexMap.build(keys, add_intercept=True).items())
    RefStore.build(str(tmp_path / "ref.pidx"), RefIndexMap.build(keys, add_intercept=True).items())
    assert (tmp_path / "port.pidx").read_bytes() == (tmp_path / "ref.pidx").read_bytes()


def test_library_builds_both_sources_into_one_hashed_name(tmp_path, monkeypatch):
    """Both sources go into one library under ``PHOTON_ML_TPU_CACHE``,
    whose name covers both: an edit to either one renames it."""
    from photon_ml_tpu_torch.native import build as native_build

    monkeypatch.setenv("PHOTON_ML_TPU_CACHE", str(tmp_path / "cache"))
    assert {p.name for p in native_build.SOURCES} == {"index_store.cc", "avro_ingest.cc"}
    name = native_build.library_path()
    assert name.parent == tmp_path / "cache"
    edited = tmp_path / "index_store.cc"
    edited.write_text(native_build.SOURCES[0].read_text() + "\n// edit\n")
    monkeypatch.setattr(native_build, "SOURCES", (edited, *native_build.SOURCES[1:]))
    assert native_build.library_path() != name


# ---------------------------------------------------------------------------
# (ii) the tools against the reference's, on test_drivers' fixture
# ---------------------------------------------------------------------------
def _write_game_avro(path: str, seed: int, n: int, outside_envelope: bool = False) -> None:
    """``tests/test_drivers.py``'s ``_write_game_avro``: 3 global features,
    2 per-user features, 8 users (float32-exact values). With
    ``outside_envelope`` the schema gains a field the native decoder does
    not take (a three-branch union), so the tools read with the Python
    codec."""
    data = synthetic_game_data(np.random.default_rng(seed), n, d_fixed=3, effects={"userId": (8, 2)})
    recs = [
        {
            "uid": f"s{i}",
            "response": float(data.y[i]),
            "offset": None,
            "weight": None,
            "features": [{"name": "g", "term": str(j), "value": float(np.float32(data.X[i, j]))}
                         for j in range(3)],
            "userFeatures": [{"name": "u", "term": str(j),
                              "value": float(np.float32(data.entity_X["userId"][i, j]))} for j in range(2)],
            "metadataMap": {"userId": f"user_{data.entity_ids['userId'][i]}"},
        }
        for i in range(n)
    ]
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"].insert(5, {"name": "userFeatures",
                                "type": {"type": "array", "items": "NameTermValueAvro"}, "default": []})
    if outside_envelope:
        schema["fields"].append({"name": "extra", "type": ["null", "int", "string"], "default": None})
    ref_write(path, schema, recs)


def _config(iterations: int = 1) -> dict:
    """``tests/test_drivers.py``'s ``_game_config`` as JSON."""
    opt = {"optimizer": {"max_iterations": 30, "tolerance": 1e-7}}
    return {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinate_update_sequence": ["fixed", "per_user"],
        "coordinate_descent_iterations": iterations,
        "fixed_effect_coordinates": {"fixed": {"feature_shard_id": "global", "optimization": opt}},
        "random_effect_coordinates": {"per_user": {
            "random_effect_type": "userId", "feature_shard_id": "per_user",
            "optimization": {**opt, "regularization": {"regularization_type": "L2"},
                             "regularization_weight": 1.0}}},
        "feature_shards": {
            "global": {"feature_bags": ["features"], "has_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "has_intercept": False},
        },
        "evaluators": ["AUC"],
    }


def _game_files(tmp_path, outside_envelope: bool = False):
    train = tmp_path / "train"
    train.mkdir()
    _write_game_avro(str(train / "part-00000.avro"), 42, 100, outside_envelope)
    _write_game_avro(str(train / "part-00001.avro"), 43, 60, outside_envelope)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(_config()))
    return str(train), str(cfg)


@pytest.fixture
def game_files(tmp_path):
    return _game_files(tmp_path)


def _quiet(cls):
    return cls(None, stream=io.StringIO())


@pytest.mark.parametrize("outside_envelope", [False, True])
@pytest.mark.parametrize("bags", [["features", "userFeatures"], ["userFeatures"], ["features", "absentBag"]])
def test_name_term_bags_writes_the_references_bytes(tmp_path, bags, outside_envelope):
    """On the native decoder, and on the Python codec where a schema lies
    outside the decoder's envelope (a bag absent from the schema too)."""
    train, _ = _game_files(tmp_path, outside_envelope)
    log = io.StringIO()
    port = name_term_bags.run([train], bags, str(tmp_path / "port"), logger=PhotonLogger(None, stream=log))
    ref = ref_name_term_bags.run([train], bags, str(tmp_path / "ref"), logger=_quiet(RefLogger))
    assert port == ref
    assert ("Python codec" in log.getvalue()) == (outside_envelope or "absentBag" in bags)
    if "features" in bags:
        assert port["features"] == [("g", "0"), ("g", "1"), ("g", "2")]
    for bag in bags:
        assert (tmp_path / "port" / f"{bag}.json").read_bytes() == (tmp_path / "ref" / f"{bag}.json").read_bytes()


@pytest.mark.parametrize("outside_envelope", [False, True])
@pytest.mark.parametrize("with_config", [True, False])
def test_index_features_writes_the_references_maps(tmp_path, with_config, outside_envelope, caplog):
    """On the native decoder, and on the Python codec where a schema lies
    outside the decoder's envelope."""
    train, cfg = _game_files(tmp_path, outside_envelope)
    cfg = cfg if with_config else None
    with caplog.at_level("WARNING", logger="photon_ml_tpu_torch.io.data_reader"):
        port = index_features.run([train], str(tmp_path / "port"), config_path=cfg, logger=_quiet(PhotonLogger))
    assert ("Python codec" in caplog.text) == outside_envelope
    ref = ref_index_features.run([train], str(tmp_path / "ref"), config_path=cfg, logger=_quiet(RefLogger))
    assert set(port) == set(ref)
    if with_config:
        assert port["global"].size == 4 and port["per_user"].size == 2  # 3 features + intercept; 2
    for sid in port:
        assert dict(port[sid].items()) == dict(ref[sid].items())
        assert port[sid].intercept_index == ref[sid].intercept_index
        on_disk = IndexMap.load(str(tmp_path / "port" / f"{sid}.npz"))
        assert dict(on_disk.items()) == dict(RefIndexMap.load(str(tmp_path / "ref" / f"{sid}.npz")).items())
    assert (tmp_path / "port" / "_sizes.json").read_bytes() == (tmp_path / "ref" / "_sizes.json").read_bytes()


def test_native_name_term_pairs_are_exact(tmp_path):
    """Names holding the key delimiter, empty terms and non-ASCII strings:
    the native decoder's pair keys give the pairs the reference's tool
    reads, where feature keys would merge ("a\x01b", "") and ("a", "b")."""
    recs = [{"uid": f"r{i}", "response": 1.0, "features": feats, "metadataMap": {}}
            for i, feats in enumerate([
                [{"name": "a\x01b", "term": "", "value": 1.0}, {"name": "a", "term": "b", "value": 2.0}],
                [{"name": "ü:9", "term": "β", "value": 3.0}, {"name": "", "term": "t", "value": 4.0}],
                [{"name": "a", "term": "b", "value": 5.0}, {"name": "12", "term": ":x", "value": 6.0}],
            ])]
    data = tmp_path / "data"
    data.mkdir()
    ref_write(str(data / "part-00000.avro"), TRAINING_EXAMPLE_SCHEMA, recs)
    log = io.StringIO()
    port = name_term_bags.run([str(data)], ["features"], str(tmp_path / "port"),
                              logger=PhotonLogger(None, stream=log))
    ref = ref_name_term_bags.run([str(data)], ["features"], str(tmp_path / "ref"), logger=_quiet(RefLogger))
    assert "Python codec" not in log.getvalue()
    assert port == ref and len(port["features"]) == 5
    assert (tmp_path / "port" / "features.json").read_bytes() == (tmp_path / "ref" / "features.json").read_bytes()


def _model_files(out: str) -> dict:
    """The trained model's files (Avro as decoded records: the sync
    marker is random), the log and checkpoints aside."""
    from photon_ml_tpu_torch.io.avro import read_avro_file

    got = {}
    for d, _, fs in os.walk(out):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), out)
            if rel.split(os.sep)[0] in ("checkpoints",) or f == "photon.log":
                continue
            full = os.path.join(d, f)
            if f.endswith(".avro"):
                got[rel] = read_avro_file(full)[1]
            elif f.endswith(".npz"):
                with np.load(full) as z:
                    got[rel] = {k: z[k].tobytes() for k in z.files}
            else:
                with open(full, "rb") as fh:
                    got[rel] = fh.read()
    return got


def test_train_with_index_maps_is_bitwise_train_without(game_files, tmp_path):
    """Index, then train with ``--index-maps`` through the umbrella: the
    model files are the ones training without the flag writes."""
    train, cfg = game_files
    idx = str(tmp_path / "index")
    umbrella.main(["index-features", "--data", train, "--config", cfg, "--output-dir", idx])
    for out, extra in (("plain", []), ("indexed", ["--index-maps", idx])):
        umbrella.main(["train", "--config", cfg, "--train-data", train, "--output-dir",
                       str(tmp_path / out), "--device", "cpu", *extra])
    plain, indexed = _model_files(str(tmp_path / "plain")), _model_files(str(tmp_path / "indexed"))
    assert "best/fixed-effect/fixed/coefficients/part-00000.avro" in plain
    assert plain == indexed
    with open(tmp_path / "indexed" / "photon.log") as f:
        assert "loaded index maps" in f.read()


def test_train_with_index_maps_in_library_form(game_files, tmp_path):
    """``cli.train.run(index_map_dir=)`` against the reference's maps
    written by its own indexing driver: the port reads them as its own."""
    train, cfg = game_files
    idx = str(tmp_path / "ref-index")
    ref_index_features.run([train], idx, config_path=cfg, logger=_quiet(RefLogger))
    config = parse_config(_config())
    a = port_train.run(config, [train], str(tmp_path / "a"), logger=_quiet(PhotonLogger), device="cpu")
    b = port_train.run(config, [train], str(tmp_path / "b"), index_map_dir=idx, logger=_quiet(PhotonLogger),
                       device="cpu")
    wa = a.model.models["fixed"].model.coefficients.means
    wb = b.model.models["fixed"].model.coefficients.means
    assert wa.tolist() == wb.tolist()


# ---------------------------------------------------------------------------
# (iii) the umbrella
# ---------------------------------------------------------------------------
def _exit_code(argv) -> tuple[int, str]:
    try:
        umbrella.main(argv)
    except SystemExit as e:
        return (e.code if isinstance(e.code, int) else 1), ("" if isinstance(e.code, int) else str(e.code))
    return 0, ""


def test_umbrella_commands_equal_the_references():
    from photon_ml_tpu.cli import main as ref_main

    ours = umbrella._commands()
    assert ours == {name: module.replace("photon_ml_tpu.", "photon_ml_tpu_torch.")
                    for name, module in ref_main._commands().items()}


@pytest.mark.parametrize("argv, code", [([], 2), (["-h"], 0), (["--help"], 0)])
def test_umbrella_usage_exit_codes(argv, code, capsys):
    assert _exit_code(argv)[0] == code
    out = capsys.readouterr().out
    assert out.startswith("usage: photon-ml-tpu-torch <command> [args...]\ncommands: ")
    assert "index-features  lint  name-term-bags  report  score  serve  train  train-glm" in out


def test_umbrella_unknown_command():
    code, message = _exit_code(["frobnicate", "--x"])
    assert code == 1
    assert message == ("unknown command 'frobnicate'; one of: index-features, lint, name-term-bags, report, "
                       "score, serve, train, train-glm")


def test_umbrella_serve_is_not_ported_yet(monkeypatch):
    """``serve`` is ported (ROADMAP queue 1 item 8): the command reaches the
    serving driver, which runs on CUDA unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        umbrella.main(["serve", "--model-root", "x"])


@pytest.mark.parametrize("command, module", [
    ("train", "photon_ml_tpu_torch.cli.train"), ("score", "photon_ml_tpu_torch.cli.score"),
    ("train-glm", "photon_ml_tpu_torch.cli.train_glm"),
    ("index-features", "photon_ml_tpu_torch.cli.index_features"),
    ("name-term-bags", "photon_ml_tpu_torch.cli.name_term_bags"), ("report", "photon_ml_tpu_torch.cli.report"),
    ("serve", "photon_ml_tpu_torch.cli.serve"), ("lint", "photon_ml_tpu_torch.cli.lint"),
])
def test_umbrella_dispatches_to_the_drivers_main(command, module, monkeypatch):
    import importlib

    seen = []
    monkeypatch.setattr(importlib.import_module(module), "main", lambda argv: seen.append(argv))
    umbrella.main([command, "--a", "b"])
    assert seen == [["--a", "b"]]


def test_umbrella_name_term_bags_end_to_end(game_files, tmp_path):
    train, _ = game_files
    umbrella.main(["name-term-bags", "--data", train, "--bags", "userFeatures", "--output-dir",
                   str(tmp_path / "bags")])
    with open(tmp_path / "bags" / "userFeatures.json") as f:
        assert json.load(f) == [{"name": "u", "term": "0"}, {"name": "u", "term": "1"}]
