"""Avro training and scoring data reader (port of ``AvroDataReader`` in
``photon_ml_tpu/io/data_reader.py``, on its pure-Python path).

Reads ``TrainingExampleAvro``-shaped records (response, optional offset,
weight and uid, bags of (name, term, value) features, and a metadata map
of entity-id tags), merges the configured bags of each feature shard into
columns through an ``IndexMap``, and gives each entity id a dense integer
in record order. Index maps take the first-seen key order, so the columns
and entity ids are the reference's integers exactly.

Each shard's arrays are built on the host in numpy and moved to the device
in one copy. The reference's C++ columnar decoder (its ``use_native``
path) is ROADMAP queue 1 item 15; the streamed reader and its chunk
iterator are item 11.
"""

from __future__ import annotations

import datetime
import os
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
from photon_ml_tpu_torch.io.avro import iter_avro_directory

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
    ) -> GameDataset:
        """Records → ``GameDataset`` with its batch on ``device`` (CUDA unless
        the caller asks for another; raises without it).

        ``index_maps`` / ``entity_maps``: the training run's maps, when
        reading validation or scoring data, so columns and entity ids line
        up; unknown features are dropped and unseen entities get id -1, as
        in the reference. ``extend_entities`` instead gives unseen entities
        fresh ids after the known ones (incremental retraining: a saved
        model keeps its rows and new entities append)."""
        dev = resolve_device(device)
        paths = [path] if isinstance(path, str) else list(path)
        records: list[dict] = []
        for p in paths:
            records.extend(iter_avro_directory(p))
        if not records:
            raise ValueError(f"no records under {paths}")

        parsed = self._parse_rows(records)
        index_maps = self._maps_from_parsed(parsed) if index_maps is None else dict(index_maps)

        frozen_entities = entity_maps is not None and not extend_entities
        ent_maps: dict[str, dict[str, int]] = (
            {t: dict(m) for t, m in entity_maps.items()} if entity_maps else {t: {} for t in id_tags}
        )
        for t in id_tags:
            ent_maps.setdefault(t, {})

        n = len(records)
        labels = np.fromiter((r[_RESPONSE] for r in records), _DTYPE, count=n)
        offsets = np.fromiter(
            (0.0 if (v := r.get(_OFFSET)) is None else v for r in records), _DTYPE, count=n
        )
        weights = np.fromiter(
            (1.0 if (v := r.get(_WEIGHT)) is None else v for r in records), _DTYPE, count=n
        )
        uids = [r.get(_UID) for r in records]
        ids = {t: np.full(n, -1, np.int64) for t in id_tags}
        for i, rec in enumerate(records):
            meta = rec.get(_METADATA) or {}
            for t in id_tags:
                v = meta.get(t)
                if v is None:
                    raise ValueError(f"record {i} missing id tag {t!r}")
                m = ent_maps[t]
                if v in m:
                    ids[t][i] = m[v]
                elif not frozen_entities:
                    m[v] = ids[t][i] = len(m)
                # else: an entity unseen in training stays -1

        features: dict[str, Features] = {
            sid: _build_features(parsed[sid], index_maps[sid], cfg.has_intercept, dev)
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
        )


def _build_features(
    parsed: _ParsedShard, index_map: IndexMap, has_intercept: bool, device
) -> Features:
    """One shard's container, built in numpy and copied to ``device`` once:
    dense (n, d) when d <= ``_DENSE_THRESHOLD`` (repeated columns in a row
    add up, in record order), else (n, k) padded sparse rows with k the
    longest row. Keys unknown to the map are dropped; the intercept, when
    the shard has one, is each row's last entry."""
    n, d = len(parsed.counts), index_map.size
    lookup = dict(index_map.items())
    cols = np.fromiter((lookup.get(k, -1) for k in parsed.keys), np.int64, count=len(parsed.keys))
    vals = np.asarray(parsed.values, np.float64).astype(_DTYPE)
    rows = np.repeat(np.arange(n, dtype=np.int64), parsed.counts)
    keep = cols >= 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if has_intercept:
        if index_map.intercept_index is None:
            # the reference adds 1 to every column of the row here
            raise ValueError("the shard has an intercept but its index map has no intercept key")
        # a stable sort by row puts each row's intercept after its features
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate([cols, np.full(n, index_map.intercept_index, np.int64)])
        vals = np.concatenate([vals, np.ones(n, _DTYPE)])
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
    if d <= _DENSE_THRESHOLD:
        X = np.zeros((n, d), _DTYPE)
        np.add.at(X, (rows, cols), vals)
        return DenseFeatures(X=torch.from_numpy(X).to(device))
    counts = np.bincount(rows, minlength=n)
    k = max(int(counts.max()) if n else 1, 1)
    slots = np.arange(len(rows), dtype=np.int64) - np.concatenate([[0], np.cumsum(counts)])[rows]
    indices = np.zeros((n, k), np.int64)
    values = np.zeros((n, k), _DTYPE)
    indices[rows, slots] = cols
    values[rows, slots] = vals
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
