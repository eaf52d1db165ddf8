"""Avro training and scoring data reader (port of ``AvroDataReader`` in
``photon_ml_tpu/io/data_reader.py``).

Reads ``TrainingExampleAvro``-shaped records (response, optional offset,
weight and uid, bags of (name, term, value) features, and a metadata map
of entity-id tags), merges the configured bags of each feature shard into
columns through an ``IndexMap``, and gives each entity id a dense integer
in record order. Index maps take the first-seen key order, so the columns
and entity ids are the reference's integers exactly.

By default, as in the reference, the records are decoded by the native
columnar decoder (``io/native_ingest.py``, one thread per part file); a
file set whose schema lies outside the decoder's envelope is read by the
Python codec instead, with one log line naming the field. Both paths give
the same dataset bit for bit. Each shard's arrays are built on the host in
numpy and moved to the device in one copy.

Out of core (the reference's streamed reader): ``streaming_ingest_stats``
makes the index maps and each shard's widest row in one pass that holds
one part file's columns at a time, and ``iter_batch_chunks`` then streams
one shard as uniform host chunks for ``ops/streaming.py``. Both run on the
native decoder when every file's schema allows it, else on the Python
codec, and give the same maps and chunks bit for bit. The out-of-core
GAME driver's reader is ``streaming_game_stats`` (the maps, the entity
dictionaries and the row count in one pass) and ``read_streamed_game``
(host numpy columns for ``game/streaming.py``), on the same decoders.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.config import FeatureShardConfig
from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.game.data import (
    DenseFeatures,
    Features,
    GameBatch,
    SparseFeatures,
    make_game_batch,
)
from photon_ml_tpu_torch.io.avro import iter_avro_directory, list_avro_files, read_avro_schema
from photon_ml_tpu_torch.io.native_ingest import ColumnarFile, OutsideEnvelope, compile_program, decode_file

_log = logging.getLogger(__name__)

# a shard this narrow or narrower is stored dense, (n, d); a wider one as
# padded sparse rows
_DENSE_THRESHOLD = 2048

# the record fields of TrainingExampleAvro (io/schemas.py) that the reader takes
_RESPONSE, _OFFSET, _WEIGHT, _UID, _METADATA = "response", "offset", "weight", "uid", "metadataMap"
# labels, offsets, weights and feature values come out as float32
_DTYPE = np.float32


@dataclass(frozen=True)
class GameDataset:
    """A read dataset: the batch on the device, and the ingest dictionaries
    that interpret it (index maps for model files, entity maps for scoring,
    uids for score files)."""

    batch: GameBatch
    index_maps: dict[str, IndexMap]
    entity_maps: dict[str, dict[str, int]]  # id tag → original id → dense id
    uids: list | None
    labels: np.ndarray
    decoder: str = "python"  # which decoder read the records: "native" or "python"

    @property
    def intercept_indices(self) -> dict[str, int | None]:
        return {sid: m.intercept_index for sid, m in self.index_maps.items()}

    def entity_names(self) -> dict[str, list[str]]:
        """Inverse entity maps (dense id → original string), for model files."""
        out: dict[str, list[str]] = {}
        for tag, m in self.entity_maps.items():
            names = [""] * len(m)
            for s, i in m.items():
                names[i] = s
            out[tag] = names
        return out


@dataclass(frozen=True)
class _ParsedShard:
    """One shard's features over all records, flat in record order: the
    keys and values of every (name, term, value), and each record's count."""

    keys: list[str]
    values: list[float]
    counts: np.ndarray  # (n,) int64


class AvroDataReader:
    """Reads Avro files or directories of part files into ``GameDataset``s.

    ``feature_shards`` maps shard id → the record fields (bags) that feed it
    and whether it has an intercept column. A bag is an array of
    ``{name, term, value}`` records (``NameTermValueAvro``)."""

    def __init__(self, feature_shards: Mapping[str, FeatureShardConfig] | None = None):
        self.feature_shards = dict(
            feature_shards
            or {"global": FeatureShardConfig(feature_bags=("features",), has_intercept=True)}
        )
        for sid, cfg in self.feature_shards.items():
            if not cfg.feature_bags:
                raise ValueError(f"feature shard {sid!r} has no feature bags")

    # -- parsing ----------------------------------------------------------------
    @staticmethod
    def _shard_keys(record: dict, cfg: FeatureShardConfig, keys: list, values: list) -> int:
        """Append the record's (key, value) pairs of one shard, bag by bag in
        the configured order; returns how many."""
        n0 = len(keys)
        for bag in cfg.feature_bags:
            for ntv in record.get(bag) or ():
                term = ntv["term"]
                keys.append(f"{ntv['name']}{DELIMITER}{term}" if term else ntv["name"])
                values.append(ntv["value"])
        return len(keys) - n0

    def _parse_rows(self, records: list[dict]) -> dict[str, _ParsedShard]:
        """Every record's pairs per shard, parsed once: index-map building
        and column filling share them."""
        out = {}
        for sid, cfg in self.feature_shards.items():
            keys: list[str] = []
            values: list[float] = []
            counts = np.fromiter(
                (self._shard_keys(rec, cfg, keys, values) for rec in records),
                dtype=np.int64, count=len(records),
            )
            out[sid] = _ParsedShard(keys, values, counts)
        return out

    def _maps_from_parsed(self, parsed: Mapping[str, _ParsedShard]) -> dict[str, IndexMap]:
        # dict.fromkeys keeps the first-seen order: row, bag, position in the bag
        return {
            sid: IndexMap.build(
                dict.fromkeys(parsed[sid].keys), add_intercept=self.feature_shards[sid].has_intercept
            )
            for sid in self.feature_shards
        }

    def build_index_maps(self, records: Iterable[dict]) -> dict[str, IndexMap]:
        """One pass collecting each shard's distinct feature keys (the
        reference's ``FeatureIndexingDriver`` / ``DefaultIndexMap``)."""
        return self._maps_from_parsed(self._parse_rows(list(records)))

    # -- read ---------------------------------------------------------------------
    def read(
        self,
        path: str | Sequence[str],
        id_tags: Sequence[str] = (),
        index_maps: Mapping[str, IndexMap] | None = None,
        entity_maps: Mapping[str, Mapping[str, int]] | None = None,
        extend_entities: bool = False,
        device=None,
        use_native: bool = True,
    ) -> GameDataset:
        """Records → ``GameDataset`` with its batch on ``device`` (CUDA unless
        the caller asks for another; raises without it).

        ``index_maps`` / ``entity_maps``: the training run's maps, when
        reading validation or scoring data, so columns and entity ids line
        up; unknown features are dropped and unseen entities get id -1, as
        in the reference. ``extend_entities`` instead gives unseen entities
        fresh ids after the known ones (incremental retraining: a saved
        model keeps its rows and new entities append).

        ``use_native`` (the default) decodes with the native columnar
        decoder unless a file's schema lies outside its envelope; the
        dataset's ``decoder`` says which decoder ran."""
        dev = resolve_device(device)
        paths = [path] if isinstance(path, str) else list(path)
        frozen_entities = entity_maps is not None and not extend_entities
        ent_maps: dict[str, dict[str, int]] = (
            {t: dict(m) for t, m in entity_maps.items()} if entity_maps else {t: {} for t in id_tags}
        )
        for t in id_tags:
            ent_maps.setdefault(t, {})
        files = self._native_files(paths, id_tags) if use_native else None
        if files is not None:
            n = sum(c.num_rows for c in files)
            if n == 0:
                raise ValueError(f"no records under {paths}")
            cols = _NativeColumns(files, n)
            labels = cols.numeric(_RESPONSE, 0.0)
            offsets, weights = cols.numeric(_OFFSET, 0.0), cols.numeric(_WEIGHT, 1.0)
            uids = [u for c in files for u in (c.uids if c.uids is not None else [None] * c.num_rows)]
            ids = cols.entity_ids(id_tags, ent_maps, frozen_entities)
            if index_maps is None:
                index_maps = {sid: cols.index_map(cfg) for sid, cfg in self.feature_shards.items()}
            triples = {sid: cols.shard_entries(cfg, index_maps[sid]) for sid, cfg in self.feature_shards.items()}
        else:
            records: list[dict] = []
            for p in paths:
                records.extend(iter_avro_directory(p))
            if not records:
                raise ValueError(f"no records under {paths}")
            n = len(records)
            parsed = self._parse_rows(records)
            if index_maps is None:
                index_maps = self._maps_from_parsed(parsed)
            labels = np.fromiter((float(r[_RESPONSE]) for r in records), _DTYPE, count=n)
            offsets = np.fromiter(
                (0.0 if (v := r.get(_OFFSET)) is None else v for r in records), _DTYPE, count=n
            )
            weights = np.fromiter(
                (1.0 if (v := r.get(_WEIGHT)) is None else v for r in records), _DTYPE, count=n
            )
            uids = [r.get(_UID) for r in records]
            ids = _record_entity_ids(records, id_tags, ent_maps, frozen_entities)
            triples = {sid: _parsed_entries(parsed[sid], index_maps[sid]) for sid in self.feature_shards}
        index_maps = dict(index_maps)

        features: dict[str, Features] = {
            sid: _build_features(*triples[sid], n, index_maps[sid], cfg.has_intercept, dev)
            for sid, cfg in self.feature_shards.items()
        }
        batch = make_game_batch(
            labels, features, id_tags=ids, offsets=offsets, weights=weights, device=dev
        )
        return GameDataset(
            batch=batch,
            index_maps=index_maps,
            entity_maps=ent_maps,
            uids=uids if any(u is not None for u in uids) else None,
            labels=labels,
            decoder="python" if files is None else "native",
        )

    def _plan_native(self, paths: list[str], id_tags: Sequence[str], uid: bool = True):
        """Every part file with its native decoder program, in file order,
        checked before any file is decoded (so a stream never switches
        decoders midway); None, after one log line naming the field, when a
        file's schema lies outside the decoder's envelope. A missing or
        malformed file raises as the Python codec would."""
        files = [f for p in paths for f in list_avro_files(p)]
        bags = list(dict.fromkeys(b for cfg in self.feature_shards.values() for b in cfg.feature_bags))
        numeric = {_RESPONSE: 0.0, _OFFSET: 0.0, _WEIGHT: 1.0}
        plans = []
        for f in files:
            try:
                prog = compile_program(
                    read_avro_schema(f), bags, numeric, _METADATA if id_tags else None, _UID,
                    non_nullable=frozenset({_RESPONSE}),
                )
                if _RESPONSE not in prog.slots:
                    raise OutsideEnvelope(_RESPONSE, "absent from the schema")
                if not uid:  # the uid is parsed and dropped
                    prog = dataclasses.replace(prog, capture_uid=False)
            except OutsideEnvelope as e:
                _log.warning(
                    "%s: schema outside the native decoder's envelope (%s); reading %s with the "
                    "Python codec", f, e, paths,
                )
                return None
            plans.append((f, prog))
        return plans

    def _native_files(self, paths: list[str], id_tags: Sequence[str]) -> list[ColumnarFile] | None:
        """Every part file decoded by the native decoder, in file order (one
        thread per file); None when ``_plan_native`` refuses the files."""
        plans = self._plan_native(paths, id_tags)
        if plans is None:
            return None
        tags = list(id_tags)
        with ThreadPoolExecutor(max_workers=max(1, min(len(plans), os.cpu_count() or 1))) as pool:
            return list(pool.map(lambda plan: decode_file(plan[0], plan[1], tags), plans))

    # -- out of core ----------------------------------------------------------------
    def build_index_maps_streaming(self, path: str | Sequence[str]) -> dict[str, IndexMap]:
        """Index maps from one streaming pass that holds the distinct keys,
        never the records (``build_index_maps`` for data beyond host RAM)."""
        return self.streaming_ingest_stats(path)[0]

    def streaming_ingest_stats(
        self, path: str | Sequence[str], use_native: bool = True
    ) -> tuple[dict[str, IndexMap], dict[str, int]]:
        """One streaming pass giving the index maps and each shard's widest
        row (``max_nnz``, the intercept included), so the out-of-core driver
        reads the data twice: these statistics, then the chunks. One part
        file's columns are held at a time."""
        paths = [path] if isinstance(path, str) else list(path)
        plans = self._plan_native(paths, (), uid=False) if use_native else None
        if plans is not None:
            return self._streaming_stats_native(plans)
        seen: dict[str, dict[str, None]] = {sid: {} for sid in self.feature_shards}
        max_nnz = {sid: 1 for sid in self.feature_shards}
        for p in paths:
            for rec in iter_avro_directory(p):
                for sid, cfg in self.feature_shards.items():
                    keys: list[str] = []
                    self._shard_keys(rec, cfg, keys, [])
                    seen[sid].update(dict.fromkeys(keys))
                    max_nnz[sid] = max(max_nnz[sid], len(keys) + int(cfg.has_intercept))
        maps = {
            sid: IndexMap.build(seen[sid], add_intercept=cfg.has_intercept)
            for sid, cfg in self.feature_shards.items()
        }
        return maps, max_nnz

    def _streaming_stats_native(self, plans) -> tuple[dict[str, IndexMap], dict[str, int]]:
        """Index maps and max nnz from the native decoder, one file at a
        time: each key is ranked by its first entry (row, bag in the
        shard's order, position in the bag), as the Python path sees it."""
        bags = list(dict.fromkeys(b for cfg in self.feature_shards.values() for b in cfg.feature_bags))
        key_rank: dict[str, dict[str, tuple]] = {b: {} for b in bags}
        per_shard_max = {sid: 1 for sid in self.feature_shards}
        row0 = 0
        for f, prog in plans:
            c = decode_file(f, prog, [])
            n_f = c.num_rows
            for bag in bags:
                b = c.bags[bag]
                ranks = key_rank[bag]
                if len(b["uniq_keys"]):
                    ids = b["ids"]
                    first_flat = np.full(len(b["uniq_keys"]), len(ids), np.int64)
                    uniq, first_idx = np.unique(ids, return_index=True)
                    first_flat[uniq] = first_idx
                    rows = np.searchsorted(b["rowptr"], first_flat, side="right") - 1
                    pos = first_flat - b["rowptr"][rows]
                    for kid, key in enumerate(b["uniq_keys"]):
                        if key not in ranks:
                            ranks[key] = (row0 + rows[kid], pos[kid])
            for sid, cfg in self.feature_shards.items():
                per_row = np.zeros(n_f, np.int64)
                for bag in cfg.feature_bags:
                    per_row += np.diff(c.bags[bag]["rowptr"])
                if n_f:
                    per_shard_max[sid] = max(per_shard_max[sid], int(per_row.max()) + int(cfg.has_intercept))
            row0 += n_f
        maps: dict[str, IndexMap] = {}
        for sid, cfg in self.feature_shards.items():
            ranked = [
                ((row, bi, pos), key)
                for bi, bag in enumerate(cfg.feature_bags)
                for key, (row, pos) in key_rank[bag].items()
            ]
            ranked.sort(key=lambda t: t[0])
            maps[sid] = IndexMap.build((k for _, k in ranked), add_intercept=cfg.has_intercept)
        return maps, per_shard_max

    def iter_batch_chunks(
        self,
        path: str | Sequence[str],
        shard_id: str,
        chunk_rows: int,
        index_maps: Mapping[str, IndexMap],
        dtype=np.float32,
        max_nnz: int | None = None,
        use_native: bool = True,
    ):
        """Stream one feature shard as uniform host chunk dicts for
        ``ops/streaming.py``: ``labels``, ``offsets``, ``weights`` and either
        ``X`` (n, d) when d <= 2048, or ``indices`` / ``values`` (n,
        ``max_nnz``) padded with index 0 and value 0. Every chunk has
        ``chunk_rows`` rows; the last is padded with zero-weight rows. The
        index maps are frozen (a stream cannot grow the feature space), and
        ``max_nnz`` comes from a statistics pass when not given. The
        intercept takes the slot right after a row's features (dense: it is
        added after them). One part file's columns are held at a time."""
        cfg = self.feature_shards[shard_id]
        imap = index_maps[shard_id]
        paths = [path] if isinstance(path, str) else list(path)
        dense = imap.size <= _DENSE_THRESHOLD
        plans = self._plan_native(paths, (), uid=False) if use_native else None
        if plans is not None:
            if not dense and max_nnz is None:
                max_nnz = self._streaming_stats_native(plans)[1][shard_id]
            yield from self._chunks_from_columnar(plans, cfg, imap, chunk_rows, dtype, max_nnz, dense)
            return
        if not dense and max_nnz is None:
            max_nnz = self.streaming_ingest_stats(paths, use_native=False)[1][shard_id]
        chunk = _empty_chunk(chunk_rows, imap.size, dtype, max_nnz, dense)
        fill = 0
        for p in paths:
            for rec in iter_avro_directory(p):
                i = fill
                chunk["labels"][i] = float(rec[_RESPONSE])
                off = rec.get(_OFFSET)
                if off is not None:
                    chunk["offsets"][i] = float(off)
                w = rec.get(_WEIGHT)
                chunk["weights"][i] = 1.0 if w is None else float(w)
                keys: list[str] = []
                values: list[float] = []
                self._shard_keys(rec, cfg, keys, values)
                pairs = [(j, float(v)) for key, v in zip(keys, values) if (j := imap.get(key)) >= 0]
                if cfg.has_intercept:
                    pairs.append((imap.intercept_index, 1.0))
                if dense:
                    for j, v in pairs:
                        chunk["X"][i, j] += v
                else:
                    if len(pairs) > max_nnz:
                        raise ValueError(f"record has {len(pairs)} features > max_nnz={max_nnz}")
                    for slot, (j, v) in enumerate(pairs):
                        chunk["indices"][i, slot] = j
                        chunk["values"][i, slot] = v
                fill += 1
                if fill == chunk_rows:
                    yield chunk
                    chunk = _empty_chunk(chunk_rows, imap.size, dtype, max_nnz, dense)
                    fill = 0
        if fill:
            yield chunk  # the rest of the last chunk stays zero-weight padding

    def streaming_game_stats(
        self,
        path: str | Sequence[str],
        id_tags: Sequence[str] = (),
        entity_maps: Mapping[str, Mapping[str, int]] | None = None,
        use_native: bool = True,
    ) -> tuple[dict[str, IndexMap], dict[str, int], dict[str, dict[str, int]], int]:
        """The out-of-core GAME driver's statistics pass over every file:
        (index maps, each shard's max nnz, entity maps per id tag, row
        count), holding the dictionaries and one file's columns at a time.
        ``entity_maps`` seeds the entity dictionaries (a warm start keeps
        the saved model's dense rows; new entities append in record
        order)."""
        paths = [path] if isinstance(path, str) else list(path)
        index_maps, max_nnz = self.streaming_ingest_stats(paths, use_native=use_native)
        ent_maps = {t: dict((entity_maps or {}).get(t, {})) for t in id_tags}
        num_rows = 0
        for cols, n_f in self._iter_scalar_columns(paths, id_tags, use_native=use_native):
            num_rows += n_f
            for t in id_tags:
                m = ent_maps[t]
                for v in cols["tags"][t]["uniq"]:  # first-seen order within the file
                    if v not in m:
                        m[v] = len(m)
        return index_maps, max_nnz, ent_maps, num_rows

    def _iter_scalar_columns(self, paths: list[str], id_tags: Sequence[str], use_native: bool = True):
        """Per file: (columns, rows) with the labels, the offsets and
        weights (None where the file has none) and, per id tag, the file's
        distinct values in first-seen order (``uniq``) and each row's index
        into them (``ids``). Features are not decoded, and per-row work is
        numpy: only the distinct values pass through Python."""
        plans = self._plan_native(paths, id_tags, uid=False) if use_native else None
        if plans is not None:
            for f, prog in plans:
                c = decode_file(f, prog, list(id_tags))
                cols = {
                    "labels": np.asarray(c.numeric[_RESPONSE], _DTYPE),
                    "offsets": np.asarray(c.numeric[_OFFSET], _DTYPE) if _OFFSET in c.numeric else None,
                    "weights": np.asarray(c.numeric[_WEIGHT], _DTYPE) if _WEIGHT in c.numeric else None,
                    "tags": {},
                }
                for t in id_tags:
                    tids = np.asarray(c.tags[t]["ids"])
                    if len(tids) and (tids < 0).any():
                        raise ValueError(f"record {int(np.flatnonzero(tids < 0)[0])} missing id tag {t!r}")
                    cols["tags"][t] = {"uniq": c.tags[t]["uniq_values"], "ids": tids}
                yield cols, c.num_rows
            return
        for p in paths:
            recs = list(iter_avro_directory(p))
            if not recs:
                continue
            n_f = len(recs)
            labels = np.zeros(n_f, _DTYPE)
            offsets = np.zeros(n_f, _DTYPE)
            weights = np.ones(n_f, _DTYPE)
            uniq: dict[str, dict] = {t: {} for t in id_tags}
            ids = {t: np.zeros(n_f, np.int64) for t in id_tags}
            for i, rec in enumerate(recs):
                labels[i] = float(rec[_RESPONSE])
                if (off := rec.get(_OFFSET)) is not None:
                    offsets[i] = float(off)
                if (w := rec.get(_WEIGHT)) is not None:
                    weights[i] = float(w)
                meta = rec.get(_METADATA) or {}
                for t in id_tags:
                    v = meta.get(t)
                    if v is None:
                        raise ValueError(f"record {i} missing id tag {t!r}")
                    ids[t][i] = uniq[t].setdefault(v, len(uniq[t]))
            yield {
                "labels": labels, "offsets": offsets, "weights": weights,
                "tags": {t: {"uniq": list(uniq[t]), "ids": ids[t]} for t in id_tags},
            }, n_f

    def read_streamed_game(
        self,
        path: str | Sequence[str],
        id_tags: Sequence[str],
        index_maps: Mapping[str, IndexMap],
        entity_maps: Mapping[str, Mapping[str, int]],
        max_nnz: Mapping[str, int] | None = None,
        dtype=np.float32,
        unseen_entity_ok: bool = False,
        use_native: bool = True,
        allow_empty: bool = False,
    ):
        """Host-resident GAME ingest for the out-of-core trainer: a
        ``game.streaming.StreamedGameData`` of numpy columns, nothing on the
        device, against the frozen dictionaries of ``streaming_game_stats``.
        The data stream once for the scalar columns and once per feature
        shard, each shard filled chunk by chunk into its preallocated
        columns (dense (n, d) up to 2048 columns, else padded (n, max nnz)
        int32 indices and values). ``unseen_entity_ok`` gives entities
        absent from ``entity_maps`` the id -1 (validation: those rows score
        0 for that coordinate) instead of raising. ``allow_empty``: paths
        with no record give a 0-row dataset with the dictionaries' shard
        widths and every id tag, instead of raising (a process of
        ``--multihost`` whose file slice is empty still takes part in every
        collective of the trainer)."""
        from photon_ml_tpu_torch.game.streaming import StreamedGameData

        paths = [path] if isinstance(path, str) else list(path)
        labels_p, offsets_p, weights_p = [], [], []
        ids_p: dict[str, list[np.ndarray]] = {t: [] for t in id_tags}
        native = use_native and self._plan_native(paths, id_tags, uid=False) is not None
        for cols, n_f in self._iter_scalar_columns(paths, id_tags, use_native=native):
            labels_p.append(cols["labels"])
            offsets_p.append(cols["offsets"] if cols["offsets"] is not None else np.zeros(n_f, _DTYPE))
            weights_p.append(cols["weights"] if cols["weights"] is not None else np.ones(n_f, _DTYPE))
            for t in id_tags:
                m, tag = entity_maps[t], cols["tags"][t]
                remap = np.empty(max(len(tag["uniq"]), 1), np.int64)
                for u, v in enumerate(tag["uniq"]):
                    got = m.get(v, -1)
                    if got < 0 and not unseen_entity_ok:
                        raise ValueError(
                            f"entity {v!r} (tag {t!r}) absent from the statistics pass's "
                            "dictionaries; did that pass cover every file?"
                        )
                    remap[u] = got
                tids = tag["ids"]
                ids_p[t].append(remap[tids] if len(tids) else np.zeros(0, np.int64))
        if not labels_p and not allow_empty:
            raise ValueError(f"no records under {paths}")
        labels = _concat(labels_p, _DTYPE)
        n = len(labels)
        features: dict[str, Features] = {}
        for sid in self.feature_shards:
            d = index_maps[sid].size
            dense = d <= _DENSE_THRESHOLD
            knnz = None
            if not dense:
                knnz = (max_nnz or {}).get(sid)
                if n == 0:
                    knnz = knnz or 1
                elif knnz is None:
                    knnz = self.streaming_ingest_stats(paths, use_native=native)[1][sid]
            # preallocated and filled chunk by chunk: a list of chunks and a
            # concatenate would hold the shard twice at its peak
            if dense:
                X = np.empty((n, d), dtype)
            else:
                idx, val = np.empty((n, knnz), np.int32), np.empty((n, knnz), dtype)
            fill, chunk_rows = 0, min(n, 1 << 20)
            chunks = self.iter_batch_chunks(paths, sid, chunk_rows=chunk_rows, index_maps=index_maps, dtype=dtype,
                                            max_nnz=knnz, use_native=native) if n else ()
            for c in chunks:
                take = min(chunk_rows, n - fill)
                if dense:
                    X[fill:fill + take] = c["X"][:take]
                else:
                    idx[fill:fill + take] = c["indices"][:take]
                    val[fill:fill + take] = c["values"][:take]
                fill += take
            features[sid] = (DenseFeatures(X=X) if dense
                             else SparseFeatures(indices=idx, values=val, num_features=d))
        return StreamedGameData(
            labels=labels, features=features,
            id_tags={t: _concat(v, np.int64) for t, v in ids_p.items()},
            offsets=_concat(offsets_p, _DTYPE), weights=_concat(weights_p, _DTYPE),
            decoder="native" if native else "python",
        )

    def _chunks_from_columnar(self, plans, cfg, imap: IndexMap, chunk_rows: int, dtype,
                              max_nnz: int | None, dense: bool):
        """Uniform chunks from the native decoder's columns, one file at a
        time (rows may span files); the same chunks as the Python path."""
        icept = imap.intercept_index if cfg.has_intercept else None
        buf = _empty_chunk(chunk_rows, imap.size, dtype, max_nnz, dense)
        fill = 0
        for f, prog in plans:
            c = decode_file(f, prog, [])
            rows, colv, vals, counts_f, rowptr_f = _file_coo(c, cfg, imap, max_nnz, dense)
            labels_f = c.numeric[_RESPONSE]
            offsets_f = c.numeric.get(_OFFSET)
            weights_f = c.numeric.get(_WEIGHT)
            n_f = c.num_rows
            r0 = 0
            while r0 < n_f:
                take = min(chunk_rows - fill, n_f - r0)
                dst = slice(fill, fill + take)
                src = slice(r0, r0 + take)
                buf["labels"][dst] = labels_f[src]
                if offsets_f is not None:
                    buf["offsets"][dst] = offsets_f[src]
                buf["weights"][dst] = weights_f[src] if weights_f is not None else 1.0
                lo, hi = rowptr_f[r0], rowptr_f[r0 + take]
                rr = rows[lo:hi] - r0 + fill
                if dense:
                    np.add.at(buf["X"], (rr, colv[lo:hi]), vals[lo:hi].astype(dtype))
                    if icept is not None:
                        buf["X"][dst, icept] += 1.0
                else:
                    slots = np.arange(lo, hi, dtype=np.int64) - rowptr_f[rows[lo:hi]]
                    buf["indices"][rr, slots] = colv[lo:hi]
                    buf["values"][rr, slots] = vals[lo:hi]
                    if icept is not None:
                        # the slot right after the row's features
                        at = np.arange(fill, fill + take)
                        buf["indices"][at, counts_f[src]] = icept
                        buf["values"][at, counts_f[src]] = 1.0
                fill += take
                r0 += take
                if fill == chunk_rows:
                    yield buf
                    buf = _empty_chunk(chunk_rows, imap.size, dtype, max_nnz, dense)
                    fill = 0
        if fill:
            yield buf


def _concat(parts: list[np.ndarray], dtype) -> np.ndarray:
    """The parts joined, or an empty column of ``dtype`` without any."""
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def _empty_chunk(chunk_rows: int, d: int, dtype, max_nnz: int | None, dense: bool) -> dict:
    chunk = {
        "labels": np.zeros(chunk_rows, dtype),
        "offsets": np.zeros(chunk_rows, dtype),
        "weights": np.zeros(chunk_rows, dtype),  # padding rows keep weight 0
    }
    if dense:
        chunk["X"] = np.zeros((chunk_rows, d), dtype)
    else:
        chunk["indices"] = np.zeros((chunk_rows, max_nnz), np.int32)
        chunk["values"] = np.zeros((chunk_rows, max_nnz), dtype)
    return chunk


def _file_coo(c: ColumnarFile, cfg: FeatureShardConfig, imap: IndexMap, max_nnz: int | None,
              dense: bool):
    """One decoded file's known entries of a shard as (rows, columns,
    values) in (row, bag, position) order, each row's count and the row
    pointer; raises when a row exceeds ``max_nnz`` on the sparse path."""
    rows_parts, cols_parts, vals_parts, pos_parts, bag_parts = [], [], [], [], []
    n_f = c.num_rows
    for bag_idx, bag in enumerate(cfg.feature_bags):
        b = c.bags[bag]
        if not len(b["ids"]):
            continue
        uniq_to_col = imap.lookup_all(np.asarray(b["uniq_keys"], np.str_))
        counts = np.diff(b["rowptr"])
        rows = np.repeat(np.arange(n_f, dtype=np.int64), counts)
        pos = np.arange(len(b["ids"]), dtype=np.int64) - b["rowptr"][rows]
        colv = uniq_to_col[b["ids"]]
        keep = colv >= 0
        rows_parts.append(rows[keep])
        cols_parts.append(colv[keep])
        vals_parts.append(b["values"][keep])
        pos_parts.append(pos[keep])
        bag_parts.append(np.full(int(keep.sum()), bag_idx, np.int64))
    if rows_parts:
        rows = np.concatenate(rows_parts)
        order = np.lexsort((np.concatenate(pos_parts), np.concatenate(bag_parts), rows))
        rows = rows[order]
        colv = np.concatenate(cols_parts)[order]
        vals = np.concatenate(vals_parts)[order]
    else:
        rows = np.zeros(0, np.int64)
        colv = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float32)
    counts_f = np.bincount(rows, minlength=n_f).astype(np.int64)
    rowptr_f = np.concatenate([[0], np.cumsum(counts_f)])
    if not dense and len(counts_f):
        worst = int(counts_f.max()) + int(cfg.has_intercept)
        if worst > max_nnz:
            raise ValueError(f"record has {worst} features > max_nnz={max_nnz}")
    return rows, colv, vals, counts_f, rowptr_f


class _NativeColumns:
    """The native decoder's per-file columns, merged into the reader's
    arrays in the order the Python path builds them: rows across files in
    order, each shard's entries by (row, bag in the shard's order, position
    in the bag)."""

    def __init__(self, files: list[ColumnarFile], n: int):
        self.files, self.n = files, n
        self._bags: dict[str, dict] = {}

    def numeric(self, name: str, default: float) -> np.ndarray:
        return np.concatenate([
            c.numeric[name] if name in c.numeric else np.full(c.num_rows, default) for c in self.files
        ]).astype(_DTYPE)

    def entity_ids(self, id_tags, ent_maps: dict, frozen: bool) -> dict[str, np.ndarray]:
        """Dense ids per tag, new entities numbered in record order (or -1
        when ``frozen``); raises at the first record that lacks a tag."""
        ids = {}
        for t in id_tags:
            m, parts = ent_maps[t], []
            for c in self.files:
                tag = c.tags[t]
                remap = np.empty(len(tag["uniq_values"]) + 1, np.int64)
                remap[-1] = -1  # a record without the tag (id -1) maps to the last slot
                for u, v in enumerate(tag["uniq_values"]):
                    if v not in m and not frozen:
                        m[v] = len(m)
                    remap[u] = m.get(v, -1)
                parts.append(np.where(tag["ids"] < 0, -2, remap[tag["ids"]]))
            ids[t] = np.concatenate(parts)
        missing = {t: np.flatnonzero(v == -2) for t, v in ids.items()}
        if any(len(rows) for rows in missing.values()):
            row = min(int(rows[0]) for rows in missing.values() if len(rows))
            tag = next(t for t in id_tags if len(missing[t]) and missing[t][0] == row)
            raise ValueError(f"record {row} missing id tag {tag!r}")
        return ids

    def bag(self, name: str) -> dict:
        """One bag over all files: a key table in first-seen order, each
        entry's key id and value, and each row's entry count."""
        if name not in self._bags:
            order: dict[str, int] = {}
            ids, values, counts = [], [], []
            for c in self.files:
                b = c.bags[name]
                remap = np.fromiter((order.setdefault(k, len(order)) for k in b["uniq_keys"]),
                                    np.int64, count=len(b["uniq_keys"]))
                ids.append(remap[b["ids"]])
                values.append(b["values"])
                counts.append(np.diff(b["rowptr"]))
            self._bags[name] = dict(keys=list(order), ids=np.concatenate(ids),
                                    values=np.concatenate(values), counts=np.concatenate(counts))
        return self._bags[name]

    def index_map(self, cfg: FeatureShardConfig) -> IndexMap:
        """The shard's map with keys in the order of their first entry."""
        if len(cfg.feature_bags) == 1:
            # a bag's key table is already in the order of first entry
            return IndexMap.build(self.bag(cfg.feature_bags[0])["keys"], add_intercept=cfg.has_intercept)
        firsts, keys = [], []
        for b, name in enumerate(cfg.feature_bags):
            mb = self.bag(name)
            if not mb["keys"]:
                continue
            # key ids are numbered in order of first entry: a new id is one
            # above every id before it
            ids = mb["ids"]
            seen = np.maximum.accumulate(np.concatenate([[-1], ids[:-1]]))
            first = np.flatnonzero(ids > seen)
            rowptr = np.concatenate([[0], np.cumsum(mb["counts"])])
            rows = np.searchsorted(rowptr, first, side="right") - 1
            firsts.append(np.stack([rows, np.full(len(first), b), first - rowptr[rows]]))
            keys += mb["keys"]
        ranked = np.concatenate(firsts, axis=1) if firsts else np.zeros((3, 0), np.int64)
        order = np.lexsort(ranked[::-1])
        return IndexMap.build([keys[i] for i in order], add_intercept=cfg.has_intercept)

    def shard_entries(self, cfg: FeatureShardConfig, index_map: IndexMap):
        """(rows, columns, values) of the shard's known features, in (row,
        bag, position) order."""
        rows, cols, vals = [], [], []
        for name in cfg.feature_bags:
            mb = self.bag(name)
            lookup = index_map.lookup_all(np.asarray(mb["keys"], np.str_)) if mb["keys"] else np.zeros(0, np.int64)
            c = lookup[mb["ids"]]
            keep = c >= 0
            rows.append(np.repeat(np.arange(self.n, dtype=np.int64), mb["counts"])[keep])
            cols.append(c[keep])
            vals.append(mb["values"][keep])
        rows, cols, vals = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
        if len(cfg.feature_bags) > 1:
            order = np.argsort(rows, kind="stable")
            rows, cols, vals = rows[order], cols[order], vals[order]
        return rows, cols, vals


def _record_entity_ids(records: list[dict], id_tags, ent_maps: dict, frozen: bool) -> dict[str, np.ndarray]:
    """The Python path's dense entity ids, record by record."""
    ids = {t: np.full(len(records), -1, np.int64) for t in id_tags}
    for i, rec in enumerate(records):
        meta = rec.get(_METADATA) or {}
        for t in id_tags:
            v = meta.get(t)
            if v is None:
                raise ValueError(f"record {i} missing id tag {t!r}")
            m = ent_maps[t]
            if v in m:
                ids[t][i] = m[v]
            elif not frozen:
                m[v] = ids[t][i] = len(m)
            # else: an entity unseen in training stays -1
    return ids


def _parsed_entries(parsed: _ParsedShard, index_map: IndexMap):
    """(rows, columns, values) of the shard's known features, in record order."""
    lookup = dict(index_map.items())
    cols = np.fromiter((lookup.get(k, -1) for k in parsed.keys), np.int64, count=len(parsed.keys))
    vals = np.asarray(parsed.values, np.float64).astype(_DTYPE)
    rows = np.repeat(np.arange(len(parsed.counts), dtype=np.int64), parsed.counts)
    keep = cols >= 0
    return rows[keep], cols[keep], vals[keep]


def _build_features(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, index_map: IndexMap,
    has_intercept: bool, device,
) -> Features:
    """One shard's container from its entries in row order, built in numpy
    and copied to ``device`` once: dense (n, d) when d <=
    ``_DENSE_THRESHOLD`` (repeated columns in a row add up, in entry
    order), else (n, k) padded sparse rows with k the longest row. The
    intercept, when the shard has one, is each row's last entry."""
    d = index_map.size
    icept = index_map.intercept_index
    if has_intercept and icept is None:
        # the reference's Python path adds 1 to every column of the row here,
        # and its native path raises
        raise ValueError("the shard has an intercept but its index map has no intercept key")
    if d <= _DENSE_THRESHOLD:
        X = np.zeros((n, d), _DTYPE)
        np.add.at(X.reshape(-1), rows * d + cols, vals)
        if has_intercept:
            X[:, icept] += _DTYPE(1.0)  # after every feature of the row
        return DenseFeatures(X=torch.from_numpy(X).to(device))
    counts = np.bincount(rows, minlength=n)
    k = max(int(counts.max()) + int(has_intercept), 1)
    slots = np.arange(len(rows), dtype=np.int64) - np.concatenate([[0], np.cumsum(counts)])[rows]
    indices = np.zeros((n, k), np.int64)
    values = np.zeros((n, k), _DTYPE)
    indices[rows, slots] = cols
    values[rows, slots] = vals
    if has_intercept:
        indices[np.arange(n), counts] = icept
        values[np.arange(n), counts] = 1.0
    return SparseFeatures(
        indices=torch.from_numpy(indices).to(device),
        values=torch.from_numpy(values).to(device),
        num_features=d,
    )


def expand_date_range(base_path: str, start_date: str, end_date: str) -> list[str]:
    """The existing daily directories of ``base_path`` in the inclusive range
    [start_date, end_date] ("YYYY-MM-DD"), as the reference's date-range
    input. Each day is looked for in two layouts, ``base/daily/YYYY/MM/DD``
    and ``base/YYYY-MM-DD``; missing days are skipped, and an empty result
    raises."""
    start = datetime.date.fromisoformat(start_date)
    end = datetime.date.fromisoformat(end_date)
    if end < start:
        raise ValueError(f"date range end {end_date} precedes start {start_date}")
    out: list[str] = []
    day = start
    while day <= end:
        for c in (
            os.path.join(base_path, "daily", f"{day.year:04d}", f"{day.month:02d}", f"{day.day:02d}"),
            os.path.join(base_path, day.isoformat()),
        ):
            if os.path.isdir(c):
                out.append(c)
                break
        day += datetime.timedelta(days=1)
    if not out:
        raise FileNotFoundError(
            f"no daily directories under {base_path!r} for [{start_date}, {end_date}] "
            "(checked daily/YYYY/MM/DD and YYYY-MM-DD layouts)"
        )
    return out
