"""The port's prefetch pipeline, chunk cache and layout cache
(``ops/prefetch.py``, ``ops/tile_cache.py``), on the CPU: items arrive in
order, a worker's error reaches the consumer with no deadlock, the byte
budget evicts into the host tier and re-entry hits it, the knobs are read
at call time, depth 0 and depth 2 give bitwise equal objectives and
solves, and the layout cache holds under concurrent workers. The same
contracts as the reference's ``tests/test_prefetch.py``."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.ops import prefetch, streaming, tile_cache
from photon_ml_tpu_torch.ops.batch import SparseBatch
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.host_lbfgs import host_lbfgs_minimize
from photon_ml_tpu_torch.optim.host_tron import host_tron_minimize
from photon_ml_tpu_torch.types import OptimizerType, TaskType

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_caches():
    prefetch.clear_cache()
    tile_cache.clear()
    yield
    prefetch.clear_cache()
    tile_cache.clear()


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_items_come_in_order(depth):
    def prepare(i):
        time.sleep(0.002 * ((7 * i) % 3))  # workers finish out of order
        return i * i

    assert list(prefetch.prefetch_iter(12, prepare, depth)) == [i * i for i in range(12)]


def test_worker_error_propagates_without_deadlock():
    started = []

    def prepare(i):
        started.append(i)
        if i == 3:
            raise KeyError("boom at 3")
        return i

    got = []
    with pytest.raises(KeyError, match="boom at 3"):
        for x in prefetch.prefetch_iter(50, prepare, 2):
            got.append(x)
    assert got == [0, 1, 2]
    time.sleep(0.05)
    assert max(started) <= 3 + 2  # the queued tail was cancelled, not run out
    # the pool still serves
    assert list(prefetch.prefetch_iter(4, lambda i: -i, 2)) == [0, -1, -2, -3]


def test_a_worker_never_nests_a_pipeline():
    def prepare(i):
        names = list(prefetch.prefetch_iter(3, lambda j: threading.current_thread().name, 2))
        return names

    for names in prefetch.prefetch_iter(2, prepare, 2):
        assert all(n.startswith("photon-prefetch") for n in names)


def test_knobs_are_read_at_call_time(monkeypatch):
    monkeypatch.delenv("PHOTON_PREFETCH_DEPTH", raising=False)
    assert prefetch.prefetch_depth() == 2
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "0")
    assert prefetch.prefetch_depth() == 0
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "-3")
    assert prefetch.prefetch_depth() == 0
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "5")
    assert prefetch.prefetch_depth() == 5
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "")
    assert prefetch.prefetch_depth() == 2
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", "12345")
    assert prefetch.chunk_cache_budget_bytes(CPU) == 12345
    assert prefetch.host_spill_budget_bytes(CPU) == 12345
    monkeypatch.delenv("PHOTON_CHUNK_CACHE_BUDGET")
    assert prefetch.chunk_cache_budget_bytes(CPU) == 2_000_000_000  # no card: the default
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
    assert prefetch.transfer_dtype() == "bf16"
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "int8")
    assert prefetch.transfer_dtype() == "bf16"
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "f32")
    assert prefetch.transfer_dtype() == "f32"


def test_byte_budget_evicts_and_the_host_tier_takes_it(monkeypatch):
    arrays = [np.full(512, i, np.float32) for i in range(4)]  # 2 KiB each, 1 KiB cast to bfloat16
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")  # the host tier keeps the cast arrays
    entry_host_bytes = 2048 + 1024  # an entry pins its array and its cast
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(2 * entry_host_bytes))
    for a in arrays:
        out = prefetch.cached_device_put({"X": a}, CPU)
        assert torch.equal(out["X"], torch.from_numpy(a).to(torch.bfloat16))
    s = prefetch.cache_stats()
    assert (s["misses"], s["evictions"], s["device_entries"], s["host_entries"]) == (4, 2, 2, 2)
    assert s["device_bytes"] == 2 * 1024 and s["host_bytes"] == 2 * entry_host_bytes
    prefetch.cached_device_put({"X": arrays[3]}, CPU)  # resident
    spilled = prefetch._host_tier[next(iter(prefetch._host_tier))][1]
    out = prefetch.cached_device_put({"X": arrays[0]}, CPU)  # spilled: one copy, no second cast
    assert out["X"] is spilled
    s = prefetch.cache_stats()
    assert (s["device_hits"], s["host_hits"], s["misses"]) == (1, 1, 4)
    # a view pins its whole base: charged at the base's size against the host budget
    base = np.zeros(64 * 1024, np.float32)
    prefetch.cached_device_put({"X": base[:16]}, CPU)
    assert prefetch.cache_stats()["device_entries"] <= 2
    prefetch.clear_cache()
    assert prefetch.cache_stats()["device_entries"] == 0 == prefetch.cache_stats()["misses"]


def test_f32_evictions_are_dropped(monkeypatch):
    arrays = [np.full(256, i, np.float32) for i in range(4)]  # 1 KiB each
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "f32")
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(2 * 1024))
    for a in arrays:
        prefetch.cached_device_put({"X": a}, CPU)
    s = prefetch.cache_stats()
    assert (s["misses"], s["evictions"], s["device_entries"], s["host_entries"], s["host_bytes"]) == (4, 2, 2, 0, 0)
    prefetch.cached_device_put({"X": arrays[0]}, CPU)  # evicted and not kept: a miss
    s = prefetch.cache_stats()
    assert (s["host_hits"], s["misses"]) == (0, 5)


def test_bf16_rung_packs_features_and_keys_by_dtype(monkeypatch):
    X = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    y = np.ones(8, np.float32)
    f32 = prefetch.cached_device_put({"X": X, "labels": y}, CPU)
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
    bf = prefetch.cached_device_put({"X": X, "labels": y}, CPU)
    assert f32["X"].dtype == torch.float32 and bf["X"].dtype == torch.bfloat16
    assert bf["labels"].dtype == torch.float32
    assert torch.equal(bf["X"], torch.from_numpy(X).to(torch.bfloat16))
    s = prefetch.cache_stats()
    assert s["misses"] == 3 and s["device_hits"] == 1  # the labels hit; X misses per rung
    packed = prefetch.pack_host_chunk({"X": X, "values": X, "labels": y})
    assert packed["X"].dtype == torch.bfloat16 and packed["labels"] is y


def _sparse_chunks(seed=0, n=768, d=700, k=4, rows=256):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return streaming.sparse_chunks(idx, val, y, rows), d


def _dense_chunks(seed=0, n=900, d=7, rows=128):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return streaming.dense_chunks(X, y, rows), d


@pytest.mark.parametrize("kind", ["dense", "tiled"])
def test_depth_0_and_depth_2_are_bitwise_equal(monkeypatch, kind):
    chunks, d = _dense_chunks() if kind == "dense" else _sparse_chunks()
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    w = np.random.default_rng(1).normal(size=d).astype(np.float32) * 0.1
    out = {}
    for depth in ("0", "2"):
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", depth)
        prefetch.clear_cache()
        obj = streaming.StreamingGLMObjective(chunks, loss, d, l2_weight=0.5,
                                              tile_sparse=kind == "tiled", device="cpu")
        v, g = obj.value_and_grad(w)
        res = host_lbfgs_minimize(obj, np.zeros(d), OptimizerConfig(max_iterations=6, tolerance=0.0))
        tron = host_tron_minimize(obj, np.zeros(d), OptimizerConfig(
            optimizer_type=OptimizerType.TRON, max_iterations=3, tolerance=0.0))
        out[depth] = (v, g, obj.hvp(w, w), obj.hessian_diag(w), res.w, tron.w,
                      torch.from_numpy(obj.stream_scores(w, 700)))
    for a, b in zip(out["0"], out["2"]):
        assert torch.equal(a, b)
    assert prefetch.cache_stats()["device_hits"] > 0  # depth 2 replays resident chunks


def test_tile_cache_under_concurrent_workers():
    chunks, d = _sparse_chunks(seed=4)
    batches = [
        SparseBatch(indices=torch.from_numpy(c["indices"]).long(), values=torch.from_numpy(c["values"]),
                    labels=torch.from_numpy(c["labels"]), offsets=torch.from_numpy(c["offsets"]),
                    weights=torch.from_numpy(c["weights"]), num_features=d)
        for c in chunks
    ]
    calls = 48
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda i: tile_cache.tiled_layout_for(batches[i % len(batches)]), range(calls)))
    s = tile_cache.stats()
    assert s["hits"] + s["misses"] == calls
    assert s["entries"] == len(batches) and len(batches) <= s["misses"] <= calls
    for i, tb in enumerate(got):
        ref = got[i % len(batches)]
        assert torch.equal(tb.m.read, ref.m.read) and torch.equal(tb.g.values, ref.g.values)
        assert tb.labels is batches[i % len(batches)].labels
    # a second objective over the same chunks packs nothing
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    streaming.StreamingGLMObjective(chunks, loss, d, tile_sparse=True, device="cpu")
    misses = tile_cache.stats()["misses"]
    second = streaming.StreamingGLMObjective(chunks, loss, d, tile_sparse=True, device="cpu")
    assert tile_cache.stats()["misses"] == misses and len(second.layout_build_s) == len(chunks)


def test_tile_cache_bounds_and_keys(monkeypatch):
    chunks, d = _sparse_chunks(seed=6)
    batches = [
        SparseBatch(indices=torch.from_numpy(c["indices"]).long(), values=torch.from_numpy(c["values"]),
                    labels=torch.from_numpy(c["labels"]), offsets=torch.from_numpy(c["offsets"]),
                    weights=torch.from_numpy(c["weights"]), num_features=d)
        for c in chunks
    ]
    monkeypatch.setattr(tile_cache, "CAPACITY", 2)
    for b in batches:
        tile_cache.tiled_layout_for(b)
    assert tile_cache.stats()["entries"] == 2
    tile_cache.tiled_layout_for(batches[0])  # evicted: packs again
    assert tile_cache.stats()["misses"] == 4
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")  # another rung misses by key
    assert tile_cache.tiled_layout_for(batches[0]).storage == "bf16"
    assert tile_cache.stats()["misses"] == 5
    monkeypatch.setattr(tile_cache, "BYTE_BUDGET", 1)  # the next miss applies it: nothing stays
    tile_cache.tiled_layout_for(batches[1])
    assert tile_cache.stats()["entries"] == 0 and tile_cache.stats()["bytes"] == 0
    fp = tile_cache.structure_fingerprint(chunks[0]["indices"], chunks[0]["values"])
    assert fp == tile_cache.structure_fingerprint(chunks[0]["indices"].copy(), chunks[0]["values"].copy())
    assert tile_cache.sparsity_fingerprint(chunks[0]["indices"], chunks[0]["values"], d)[1] == d


def test_stage_seconds_account_the_pipeline(monkeypatch):
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "2")
    prefetch.reset_stage_seconds()
    chunks, d = _dense_chunks(seed=2)
    obj = streaming.StreamingGLMObjective(chunks, loss_for_task(TaskType.LOGISTIC_REGRESSION), d,
                                          device="cpu")
    obj.value_and_grad(np.zeros(d, np.float32))
    s = dict(prefetch.stage_seconds)
    assert set(s) == {"host_pack_s", "device_put_s", "consumer_wait_s"}
    assert all(v >= 0.0 for v in s.values()) and s["device_put_s"] > 0.0
