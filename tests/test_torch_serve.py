"""Online serving in the port (``photon_ml_tpu_torch/serve``, ``ops/bytelru``,
the published-model functions of ``io/model_io`` and ``cli/serve``), on
the CPU: the reference's ``tests/test_serve.py`` cases against the port's
own contracts, then the port against the JAX package on the same numpy
coefficients and traces.

Held to:

- the hot set: a Zipf trace's hits, misses, evictions and byte counters
  step for step an OrderedDict LRU of the same row capacity; the budget
  from the constructor, else ``PHOTON_SERVE_HOT_BYTES``, else 25% of the
  random-effect bytes; padding and out-of-range rows never touch it;
- micro-windows (a fake clock): max wait fires a partial window at exactly
  ``next_deadline()``, a single request scores, a burst larger than the max
  batch flushes full windows inside ``submit``;
- window scores: bitwise the batch scorer (``GameModel.score``) on the rows
  each window scores, padding included, with out-of-range ids; within
  rtol = atol = 1e-6 of the batch scorer on the whole set (torch's CPU
  matrix-vector product gives the rows at a thread chunk's end and at the
  n mod 4 tail other bits than aligned rows); within the float32 GAME
  tolerance (rtol = atol = 1e-5) of the reference's serving;
- refresh: bitwise the offline solve of the same bucket for L-BFGS (L1 off
  and on), TRON and NEWTON_CHOLESKY, one row replaced, the rest byte for
  byte; within the lane tolerance (atol 2e-3, rtol 1e-2) of the
  reference's refresh; ``refresh_stream`` is the per-item loop;
- the load generator: the reference's traces for the same seed;
- the manifest: seq, fingerprint, a crash mid-commit, a future schema; a
  root either package publishes loads in the other with equal
  fingerprints;
- the driver: its JSON line (the reference's keys), a bare model
  directory, a hot swap, CUDA unless the CPU is asked for;
- ``PHOTON_STREAM_EXECUTOR=1`` raises naming ROADMAP queue 1 item 9 at
  every consumer the reference routes through its executor; ``0`` gives
  the unset bits;
- two gloo processes: cross-owner requests over the exchange, then a
  peer killed mid-step, the survivor's degrade and retried step, scores
  bitwise the batch scorer at the window shape throughout.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.game.data import make_game_batch
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.serve.loadgen import open_loop_arrivals, run_serve_trace, zipf_entity_trace
from photon_ml_tpu_torch.serve.refresh import (
    RefreshBuffer,
    entity_event_batch,
    refresh_entity,
    refresh_stream,
    solve_entity_offline,
)
from photon_ml_tpu_torch.serve.router import MicroWindowServer, ScoreRequest
from photon_ml_tpu_torch.serve.store import HotModelStore
from photon_ml_tpu_torch.types import OptimizerType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANE_TOL = dict(atol=2e-3, rtol=1e-2)  # the lane solvers' pinned tolerance (ROADMAP queue 3)
GAME_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 scoring of the same coefficients in two packages


def _u32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _arrays(E: int = 32, d_fe: int = 4, d_re: int = 3, seed: int = 0) -> dict:
    """A fixed effect and one per-member random effect as numpy arrays
    (the reference test's model)."""
    rng = np.random.default_rng(seed)
    return {"fixed": (rng.normal(size=d_fe) * 0.5).astype(np.float32),
            "per_member": (rng.normal(size=(E, d_re)) * 0.5).astype(np.float32)}


def _port_model(arrays: dict, device="cpu"):
    return game_model_from_numpy({
        "fixed": {"feature_shard_id": "global", "means": arrays["fixed"]},
        "per_member": {"feature_shard_id": "member_f", "random_effect_type": "member",
                       "coefficients": arrays["per_member"]},
    }, "LOGISTIC_REGRESSION", device=device)


def _jax_model(arrays: dict):
    import jax.numpy as jnp

    from photon_ml_tpu.game.models import FixedEffectModel, GameModel, RandomEffectModel
    from photon_ml_tpu.models.glm import Coefficients, GeneralizedLinearModel

    return GameModel(models={
        "fixed": FixedEffectModel(model=GeneralizedLinearModel(Coefficients(jnp.asarray(arrays["fixed"]))),
                                  feature_shard_id="global"),
        "per_member": RandomEffectModel(coefficients=jnp.asarray(arrays["per_member"]), variances=None,
                                        random_effect_type="member", feature_shard_id="member_f"),
    })


def _game_model(E: int = 32, d_fe: int = 4, d_re: int = 3, seed: int = 0):
    return _port_model(_arrays(E, d_fe, d_re, seed))


def _requests(model, n: int, seed: int, entities=None, cls=ScoreRequest):
    """The reference test's request stream (the same draws), as ``cls``."""
    E, d_re = model["per_member"].coefficients.shape
    d_fe = int(model["fixed"].coefficient_means.shape[0])
    rng = np.random.default_rng(seed)
    ents = np.asarray(entities) if entities is not None else rng.integers(0, E, size=n)
    return [
        cls(rid=i, features={"global": rng.normal(size=d_fe).astype(np.float32),
                             "member_f": rng.normal(size=d_re).astype(np.float32)},
            id_tags={"member": int(ents[i])}, offset=float((i % 5) * 0.1))
        for i in range(n)
    ]


def _batch_scores(model, reqs) -> np.ndarray:
    """The batch scorer over the requests' rows as one batch, on the
    model's device."""
    batch = make_game_batch(
        np.zeros(len(reqs), np.float32),
        {s: np.stack([r.features[s] for r in reqs]) for s in ("global", "member_f")},
        id_tags={"member": np.asarray([r.id_tags["member"] for r in reqs], np.int64)},
        offsets=np.asarray([r.offset for r in reqs], np.float32), device=model["fixed"].coefficient_means.device)
    return model.score(batch).cpu().numpy()


def _window_shaped_scores(model, reqs, B: int) -> np.ndarray:
    """The batch scorer on the rows each window of ``B`` scores: the
    requests in windows of ``B``, each padded with zero rows of id -1."""
    out = []
    for lo in range(0, len(reqs), B):
        win = reqs[lo:lo + B]
        pad = [ScoreRequest(rid=-1, features={s: np.zeros_like(win[0].features[s]) for s in win[0].features},
                            id_tags={"member": -1}) for _ in range(B - len(win))]
        out.append(_batch_scores(model, win + pad)[:len(win)])
    return np.concatenate(out)


def _assert_window_parity(model, reqs, got: np.ndarray, B: int, tol: float = 1e-6) -> None:
    np.testing.assert_array_equal(_u32(got), _u32(_window_shaped_scores(model, reqs, B)))
    np.testing.assert_allclose(got, _batch_scores(model, reqs), rtol=tol, atol=tol)


class _FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def _serve(store, reqs, max_batch: int):
    out = []
    server = MicroWindowServer(store, on_scores=lambda w, s: out.append(np.asarray(s)), max_batch=max_batch,
                               max_wait_ms=1000.0, clock=_FakeClock())
    for r in reqs:
        server.submit(r)
    server.drain()
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# the byte-budgeted LRU and the hot set
# ---------------------------------------------------------------------------
def test_bytelru_budget_at_call_time_no_pin_and_hooks():
    from photon_ml_tpu_torch.ops.bytelru import ByteBudgetLRU

    budget = [10]
    seen = {"hit": [], "miss": [], "evict": []}
    lru = ByteBudgetLRU(lambda: budget[0], on_hit=seen["hit"].append, on_miss=seen["miss"].append,
                        on_evict=seen["evict"].append)
    assert lru.put("a", 1, 4) == 1 and lru.put("b", 2, 4) == 2
    assert lru.get("a") == 1  # recency: b is now the least recent
    lru.put("c", 3, 4)  # 12 > 10: b goes
    assert "b" not in lru and lru.stats() == {"entries": 2, "bytes": 8}
    assert lru.put("huge", 4, 11) == 4 and "huge" not in lru  # larger than the whole budget: not admitted
    assert lru.stats() == {"entries": 2, "bytes": 8}
    budget[0] = 4  # read at the next admission
    lru.put("d", 5, 4)
    assert list(lru._entries) == ["d"] and lru.bytes == 4
    lru.drop("d")
    assert len(lru) == 0 and lru.bytes == 0
    assert lru.get("zzz") is None
    assert seen == {"hit": [4], "miss": [4, 4, 4, 11, 4], "evict": [4, 4, 4]}


class TestHotModelStore:
    def test_zipf_trace_matches_reference_lru(self):
        """Hits, misses, evictions and the registry's byte counters agree
        step for step with an OrderedDict LRU of the same row capacity over
        a Zipf(1) trace."""
        E, d_re = 64, 4
        model = _game_model(E=E, d_re=d_re, seed=3)
        row_bytes, cap_rows = d_re * 4, 12
        store = HotModelStore(model, budget_bytes=cap_rows * row_bytes, device="cpu")
        ids = zipf_entity_trace(E, 2000, rng=np.random.default_rng(7))
        REGISTRY.reset("serve.hot.")
        lru: OrderedDict = OrderedDict()
        hits = misses = evictions = 0
        for e in ids:
            e = int(e)
            got = store.shard_for("per_member", e)
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(_u32(got), _u32(store.host_row("per_member", e)))
            if e in lru:
                hits += 1
                lru.move_to_end(e)
            else:
                misses += 1
                lru[e] = True
                if len(lru) > cap_rows:
                    lru.popitem(last=False)
                    evictions += 1
        assert (store._hits, store._misses) == (hits, misses)
        assert store.hit_rate() == pytest.approx(hits / (hits + misses))
        counters = REGISTRY.snapshot("serve.hot.")["counters"]
        assert counters["serve.hot.hit_bytes"]["value"] == hits * row_bytes
        assert counters["serve.hot.miss_bytes"]["value"] == misses * row_bytes
        assert counters["serve.hot.evictions"]["value"] == evictions
        st = store.stats()
        assert st["bytes"] <= store.budget_bytes() and st["entries"] == cap_rows
        assert st["hit_rate"] == store.hit_rate()

    def test_budget_resolution_explicit_env_default(self, monkeypatch):
        model = _game_model(E=16, d_re=4)
        total = 16 * 4 * 4
        monkeypatch.delenv("PHOTON_SERVE_HOT_BYTES", raising=False)
        store = HotModelStore(model, device="cpu")
        assert store.total_re_bytes == total
        assert store.budget_bytes() == total // 4
        monkeypatch.setenv("PHOTON_SERVE_HOT_BYTES", "96")
        assert store.budget_bytes() == 96
        assert HotModelStore(model, budget_bytes=32, device="cpu").budget_bytes() == 32

    def test_invalid_rows_bypass_hot_set(self):
        model = _game_model(E=8, d_re=3)
        store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")
        rows = store.rows_for("per_member", np.asarray([2, 0, 5, 0]), valid=np.asarray([True, False, True, False]))
        np.testing.assert_array_equal(_u32(rows[0]), _u32(store.host_row("per_member", 2)))
        np.testing.assert_array_equal(_u32(rows[2]), _u32(store.host_row("per_member", 5)))
        np.testing.assert_array_equal(rows[1].numpy(), np.zeros(3, np.float32))
        np.testing.assert_array_equal(rows[3].numpy(), np.zeros(3, np.float32))
        assert (store._hits, store._misses) == (0, 2)
        np.testing.assert_array_equal(store.shard_for("per_member", 99).numpy(), np.zeros(3, np.float32))
        assert (store._hits, store._misses) == (0, 2)

    def test_store_needs_cuda_unless_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HotModelStore(_game_model())


# ---------------------------------------------------------------------------
# micro-window flush edges and window parity
# ---------------------------------------------------------------------------
class TestMicroWindowFlush:
    def _server(self, model, clock, max_batch=8, max_wait_ms=5.0):
        store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")
        flushed = []
        server = MicroWindowServer(store, on_scores=lambda w, s: flushed.append((list(w), np.asarray(s))),
                                   max_batch=max_batch, max_wait_ms=max_wait_ms, clock=clock)
        return store, server, flushed

    def test_max_wait_fires_with_partial_batch(self):
        model = _game_model()
        clock = _FakeClock()
        _, server, flushed = self._server(model, clock)
        for r in _requests(model, 3, seed=1):
            server.submit(r)
        assert server.windows == 0 and not flushed
        server.poll(now=0.005 - 1e-9)
        assert server.windows == 0
        deadline = server.next_deadline()
        assert deadline == 0.0 + 5.0 / 1e3
        server.poll(now=deadline)
        assert server.windows == 1
        window, scores = flushed[0]
        assert [r.rid for r in window] == [0, 1, 2] and scores.shape == (3,)
        assert server.occupancy_mean() == pytest.approx(3 / 8)
        assert server.next_deadline() is None

    def test_single_request_window(self):
        model = _game_model()
        clock = _FakeClock()
        _, server, flushed = self._server(model, clock)
        reqs = _requests(model, 1, seed=2)
        server.submit(reqs[0])
        clock.t = 1.0
        server.poll()
        assert server.windows == 1
        _assert_window_parity(model, reqs, flushed[0][1], 8)

    def test_burst_larger_than_max_batch(self):
        model = _game_model()
        _, server, flushed = self._server(model, _FakeClock(), max_batch=4)
        reqs = _requests(model, 11, seed=3)
        for r in reqs:
            server.submit(r)
        assert server.windows == 2 and len(server._pending) == 3
        server.drain()
        assert server.windows == 3 and not server._pending
        assert [len(w) for w, _ in flushed] == [4, 4, 3]
        assert [r.rid for w, _ in flushed for r in w] == list(range(11))
        _assert_window_parity(model, reqs, np.concatenate([s for _, s in flushed]), 4)

    @pytest.mark.parametrize("d_fe", [4, 65])
    def test_window_scores_match_batch_driver_with_out_of_range(self, d_fe):
        """Out-of-range ids (negative, = E, > E) mask to 0 as
        ``RandomEffectModel.score`` masks them; the last window is partial."""
        model = _game_model(E=16, d_fe=d_fe)
        ents = np.random.default_rng(4).integers(0, 16, size=2011)
        ents[5], ents[17], ents[23] = -1, 16, 21
        reqs = _requests(model, 2011, seed=4, entities=ents)
        store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")
        got = _serve(store, reqs, 32)
        _assert_window_parity(model, reqs, got, 32)
        # the transformer (the batch scoring driver) gives the batch scorer's bits
        from photon_ml_tpu_torch.transformers import GameTransformer

        batch = make_game_batch(np.zeros(len(reqs), np.float32),
                                {s: np.stack([r.features[s] for r in reqs]) for s in ("global", "member_f")},
                                id_tags={"member": ents}, offsets=np.asarray([r.offset for r in reqs], np.float32),
                                device="cpu")
        np.testing.assert_array_equal(_u32(GameTransformer(model, device="cpu").transform(batch)),
                                      _u32(_batch_scores(model, reqs)))

    def test_window_scores_match_the_references_serving(self):
        """The same coefficients and requests through the reference's
        ``MicroWindowServer``."""
        from photon_ml_tpu.serve.router import MicroWindowServer as JServer
        from photon_ml_tpu.serve.router import ScoreRequest as JRequest
        from photon_ml_tpu.serve.store import HotModelStore as JStore

        arrays = _arrays(E=16, d_fe=6, d_re=4, seed=9)
        ents = np.random.default_rng(5).integers(-2, 18, size=77)
        reqs = _requests(_port_model(arrays), 77, seed=6, entities=ents)
        jreqs = _requests(_port_model(arrays), 77, seed=6, entities=ents, cls=JRequest)
        got = _serve(HotModelStore(_port_model(arrays), budget_bytes=64, device="cpu"), reqs, 8)
        out = []
        js = JServer(JStore(_jax_model(arrays), budget_bytes=64), on_scores=lambda w, s: out.append(np.asarray(s)),
                     max_batch=8, max_wait_ms=1000.0, clock=_FakeClock())
        for r in jreqs:
            js.submit(r)
        js.drain()
        np.testing.assert_allclose(got, np.concatenate(out), **GAME_TOL)


# ---------------------------------------------------------------------------
# refresh
# ---------------------------------------------------------------------------
SOLVER_CASES = {
    "lbfgs": (OptimizerType.LBFGS, 0.0),
    "owlqn": (OptimizerType.LBFGS, 0.05),
    "tron": (OptimizerType.TRON, 0.0),
    "newton": (OptimizerType.NEWTON_CHOLESKY, 0.0),
}


def _events(k=12, d=3, seed=6):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(k, d)).astype(np.float32), (rng.uniform(size=k) < 0.5).astype(np.float32)


class TestRefreshParity:
    @pytest.mark.parametrize("case", list(SOLVER_CASES))
    def test_refresh_bitwise_matches_offline_solve(self, case):
        """The chunked warm-start refresh is bitwise the one-shot offline
        solve of the same bucket, and replaces exactly one row."""
        solver, l1 = SOLVER_CASES[case]
        model = _game_model(E=16, d_re=3, seed=5)
        W0 = model["per_member"].coefficients.numpy().copy()
        entity = 6
        X, y = _events()
        batch = entity_event_batch(X, y, device="cpu")
        cfg = OptimizerConfig(optimizer_type=solver, max_iterations=40, tolerance=1e-7)
        updated, res = refresh_entity(model, "per_member", entity, batch, cfg, l2_weight=1.0, l1_weight=l1,
                                      chunk=3)
        offline = solve_entity_offline(model["per_member"], entity, batch, cfg, l2_weight=1.0, l1_weight=l1)
        np.testing.assert_array_equal(_u32(res.w), _u32(offline.w))
        # past the first chunk bound (3), where a chunked solver has one
        assert int(res.iterations[0]) == int(offline.iterations[0]) > (0 if case == "newton" else 3)
        W1 = updated["per_member"].coefficients.numpy()
        np.testing.assert_array_equal(_u32(W1[entity]), _u32(res.w[0]))
        assert not np.array_equal(_u32(W1[entity]), _u32(W0[entity]))
        mask = np.arange(16) != entity
        np.testing.assert_array_equal(_u32(W1[mask]), _u32(W0[mask]))

    @pytest.mark.parametrize("case", ["lbfgs", "owlqn"])
    def test_refreshed_row_matches_the_references_refresh(self, case):
        from photon_ml_tpu.config import OptimizerConfig as JOptimizerConfig
        from photon_ml_tpu.serve.refresh import entity_event_batch as j_event_batch
        from photon_ml_tpu.serve.refresh import refresh_entity as j_refresh

        _, l1 = SOLVER_CASES[case]
        arrays = _arrays(E=16, d_re=3, seed=5)
        X, y = _events()
        kw = dict(max_iterations=40, tolerance=1e-7)
        _, res = refresh_entity(_port_model(arrays), "per_member", 6, entity_event_batch(X, y, device="cpu"),
                                OptimizerConfig(**kw), l2_weight=1.0, l1_weight=l1)
        _, jres = j_refresh(_jax_model(arrays), "per_member", 6, j_event_batch(X, y), JOptimizerConfig(**kw),
                            l2_weight=1.0, l1_weight=l1)
        np.testing.assert_allclose(res.w[0].numpy(), np.asarray(jres.w), **LANE_TOL)

    def test_entity_event_batch_pads_pow2_with_inert_rows(self):
        batch = entity_event_batch(np.ones((5, 3), np.float32), np.ones((5,), np.float32), device="cpu")
        assert batch.X.shape == (8, 3)
        np.testing.assert_array_equal(batch.weights.numpy(), [1, 1, 1, 1, 1, 0, 0, 0])
        np.testing.assert_array_equal(batch.X[5:].numpy(), 0.0)
        one = entity_event_batch(np.ones((1, 3), np.float32), np.ones((1,), np.float32), device="cpu")
        assert one.X.shape == (1, 3)

    def test_refresh_buffer_trigger_knob(self, monkeypatch):
        monkeypatch.setenv("PHOTON_SERVE_REFRESH_EVERY", "3")
        buf = RefreshBuffer()
        x = np.ones(3, np.float32)
        assert buf.add("per_member", 4, x, 1.0) is False
        assert buf.add("per_member", 4, x, 0.0) is False
        assert buf.count("per_member", 4) == 2
        assert buf.add("per_member", 4, x, 1.0) is True
        batch = buf.pop_ready("per_member", 4, device="cpu")
        assert batch is not None and batch.X.shape == (4, 3)
        np.testing.assert_array_equal(batch.weights.numpy(), [1, 1, 1, 0])
        assert buf.count("per_member", 4) == 0 and buf.pop_ready("per_member", 4, device="cpu") is None
        monkeypatch.setenv("PHOTON_SERVE_REFRESH_EVERY", "0")
        for _ in range(5):
            assert buf.add("per_member", 9, x, 1.0) is False
        assert buf.count("per_member", 9) == 5

    def test_refresh_stream_is_the_per_item_loop(self):
        model = _game_model(E=16, d_re=3, seed=5)
        cfg = OptimizerConfig(max_iterations=30, tolerance=1e-7)
        items = []
        for ent, seed in ((3, 1), (7, 2), (3, 3)):
            X, y = _events(k=5 + seed, seed=seed)
            items.append(("per_member", ent, X, y, None, None))
        got, results = refresh_stream(model, items, cfg, l2_weight=1.0, device="cpu")
        want = model
        for cid, ent, X, y, _, _ in items:
            want, _ = refresh_entity(want, cid, ent, entity_event_batch(X, y, device="cpu"), cfg, l2_weight=1.0)
        assert len(results) == 3
        np.testing.assert_array_equal(_u32(got["per_member"].coefficients), _u32(want["per_member"].coefficients))
        REGISTRY.reset("serve.refresh")
        refresh_stream(model, items[:1], cfg, device="cpu")
        snap = REGISTRY.snapshot("serve.refresh")
        assert snap["counters"]["serve.refresh.count"]["value"] == 1
        assert snap["timers"]["serve.refresh_s"]["calls"] == 1

    def test_install_refreshed_row_drops_stale_hot_shard(self):
        model = _game_model(E=8, d_re=3, seed=7)
        store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")
        stale = np.array(store.host_row("per_member", 2))
        store.shard_for("per_member", 2)
        store.shard_for("per_member", 2)
        assert (store._hits, store._misses) == (1, 1)
        others = _requests(model, 12, seed=8, entities=np.asarray([0, 1, 3, 4, 5, 6, 7] * 2)[:12])
        before = _serve(store, others, 4)
        fresh = np.asarray([1.25, -2.5, 0.5], np.float32)
        store.install_refreshed_row("per_member", 2, torch.from_numpy(fresh))
        np.testing.assert_array_equal(_u32(store.host_row("per_member", 2)), _u32(fresh))
        assert not np.array_equal(_u32(stale), _u32(fresh))
        hits0, misses0 = store._hits, store._misses
        np.testing.assert_array_equal(_u32(store.shard_for("per_member", 2)), _u32(fresh))
        assert (store._hits, store._misses) == (hits0, misses0 + 1)
        np.testing.assert_array_equal(_u32(before), _u32(_serve(store, others, 4)))
        np.testing.assert_array_equal(_u32(store.model["per_member"].coefficients[2]), _u32(fresh))
        # the model the store was built from is not written through
        np.testing.assert_array_equal(_u32(model["per_member"].coefficients[2]), _u32(stale))


# ---------------------------------------------------------------------------
# the load generator
# ---------------------------------------------------------------------------
class TestLoadgen:
    def test_zipf_trace_shape_and_range(self):
        ids = zipf_entity_trace(32, 500, rng=np.random.default_rng(0))
        assert ids.shape == (500,) and ids.dtype == np.int64
        assert ids.min() >= 0 and ids.max() < 32
        assert np.bincount(ids, minlength=32).max() > 500 / 32 * 3

    def test_open_loop_arrivals_monotone(self):
        t = open_loop_arrivals(200, 1000.0, rng=np.random.default_rng(1))
        assert t.shape == (200,) and np.all(np.diff(t) >= 0) and t[0] >= 0

    @pytest.mark.parametrize("s", [0.8, 1.0, 1.3])
    def test_traces_equal_the_references(self, s):
        from photon_ml_tpu.serve.loadgen import open_loop_arrivals as j_arrivals
        from photon_ml_tpu.serve.loadgen import zipf_entity_trace as j_zipf

        np.testing.assert_array_equal(zipf_entity_trace(1000, 3000, s=s, rng=np.random.default_rng(11)),
                                      j_zipf(1000, 3000, s=s, rng=np.random.default_rng(11)))
        np.testing.assert_array_equal(open_loop_arrivals(3000, 2000.0 * s, rng=np.random.default_rng(12)),
                                      j_arrivals(3000, 2000.0 * s, rng=np.random.default_rng(12)))

    def test_run_serve_trace_summary_contract(self):
        model = _game_model(E=16)
        store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")
        reqs = _requests(model, 64, seed=9)
        for r, t in zip(reqs, open_loop_arrivals(64, 5000.0, rng=np.random.default_rng(2))):
            r.arrival_s = float(t)
        summary = run_serve_trace(store, reqs, max_batch=8, max_wait_ms=1.0)
        assert summary["requests"] == 64 and summary["windows"] >= 64 // 8 and len(summary["scores"]) == 64
        for key in ("latency_p50_ms", "latency_p99_ms", "latency_mean_ms", "hot_hit_rate",
                    "window_occupancy_mean", "elapsed_s"):
            assert key in summary, key
        assert summary["latency_p99_ms"] >= summary["latency_p50_ms"] >= 0
        got = np.asarray([summary["scores"][r.rid] for r in reqs], np.float32)
        np.testing.assert_allclose(got, _batch_scores(model, reqs), rtol=1e-6, atol=1e-6)
        gauges = REGISTRY.snapshot("serve.")["gauges"]
        assert gauges["serve.latency_p50_ms"] == summary["latency_p50_ms"]
        assert gauges["serve.hot.hit_rate"] == summary["hot_hit_rate"]
        assert gauges["serve.window.occupancy_mean"] == summary["window_occupancy_mean"]

    def test_simulated_clock_trace_is_open_loop(self):
        """With an injected clock that only the sleeps advance (arrivals 1 ms
        apart, max batch 4, max wait 2.5 ms), every window flushes at its
        oldest request's deadline with 3 requests (the last with 1), and
        each latency runs from the scheduled arrival to that flush."""
        model = _game_model(E=16)
        store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")
        clock = _FakeClock()

        def sleep(s):
            clock.t += s

        reqs = _requests(model, 40, seed=10)
        for i, r in enumerate(reqs):
            r.arrival_s = 0.001 * i
        summary = run_serve_trace(store, reqs, max_batch=4, max_wait_ms=2.5, clock=clock, sleep=sleep)
        assert summary["windows"] == 14
        assert summary["window_occupancy_mean"] == pytest.approx((13 * 3 + 1) / (14 * 4))
        assert summary["latency_p50_ms"] == pytest.approx(1.5, abs=1e-9)
        assert summary["latency_p99_ms"] == pytest.approx(2.5, abs=1e-9)


# ---------------------------------------------------------------------------
# the published-model manifest
# ---------------------------------------------------------------------------
class TestPublishedManifest:
    def test_publish_seq_fingerprint_and_load(self, tmp_path):
        from photon_ml_tpu_torch.io.model_io import (
            load_published_model,
            model_fingerprint,
            peek_published_fingerprint,
            publish_game_model,
            read_model_manifest,
        )

        root = str(tmp_path / "pub")
        a, b = _game_model(seed=11), _game_model(seed=12)
        snap1 = publish_game_model(a, root)
        m1 = read_model_manifest(root)
        assert m1["seq"] == 1 and m1["schema_version"] == 1 and os.path.isdir(snap1)
        assert m1["snapshot"] == os.path.join("snapshots", "snap-000001")
        assert peek_published_fingerprint(root) == model_fingerprint(a)
        publish_game_model(b, root)
        assert read_model_manifest(root)["seq"] == 2
        assert peek_published_fingerprint(root) == model_fingerprint(b)
        loaded, manifest = load_published_model(root, device="cpu")
        assert manifest["seq"] == 2 and model_fingerprint(loaded) == model_fingerprint(b)
        np.testing.assert_array_equal(_u32(loaded["per_member"].coefficients), _u32(b["per_member"].coefficients))

    def test_crash_mid_commit_never_shadows_previous(self, tmp_path, monkeypatch):
        from photon_ml_tpu_torch.io.model_io import (
            load_published_model,
            model_fingerprint,
            publish_game_model,
            read_model_manifest,
        )

        root = str(tmp_path / "pub")
        a, b = _game_model(seed=13), _game_model(seed=14)
        publish_game_model(a, root)

        class Boom(RuntimeError):
            pass

        real_fsync = os.fsync

        def dying_fsync(fd):
            raise Boom()

        monkeypatch.setattr(os, "fsync", dying_fsync)
        with pytest.raises(Boom):
            publish_game_model(b, root)
        monkeypatch.setattr(os, "fsync", real_fsync)
        manifest = read_model_manifest(root)
        assert manifest["seq"] == 1 and manifest["fingerprint"] == model_fingerprint(a)
        assert model_fingerprint(load_published_model(root, device="cpu")[0]) == model_fingerprint(a)
        assert [f for f in os.listdir(root) if f.endswith(".tmp")] == []
        publish_game_model(b, root)
        assert read_model_manifest(root)["seq"] == 2
        assert model_fingerprint(load_published_model(root, device="cpu")[0]) == model_fingerprint(b)

    def test_future_schema_refused_and_unpublished_raises(self, tmp_path):
        from photon_ml_tpu_torch.io.model_io import (
            MODEL_MANIFEST,
            load_published_model,
            peek_published_fingerprint,
            read_model_manifest,
        )

        root = str(tmp_path / "pub")
        os.makedirs(root)
        assert read_model_manifest(root) is None and peek_published_fingerprint(root) is None
        with pytest.raises(FileNotFoundError):
            load_published_model(root, device="cpu")
        with open(os.path.join(root, MODEL_MANIFEST), "w") as f:
            json.dump({"schema_version": 99, "seq": 1, "snapshot": "snapshots/snap-000001"}, f)
        with pytest.raises(ValueError, match="schema v99"):
            read_model_manifest(root)

    @pytest.mark.parametrize("publisher", ["port", "reference"])
    def test_a_root_either_package_publishes_loads_in_the_other(self, tmp_path, publisher):
        from photon_ml_tpu.io import model_io as jio
        from photon_ml_tpu_torch.io import model_io as tio

        arrays = _arrays(E=40, d_fe=5, d_re=4, seed=21)
        port, ref = _port_model(arrays), _jax_model(arrays)
        root = str(tmp_path / "pub")
        for _ in range(2):  # seq 2: the pointer moved once
            (tio.publish_game_model(port, root) if publisher == "port" else jio.publish_game_model(ref, root))
        want = tio.model_fingerprint(port)
        assert want == jio.model_fingerprint(ref)
        assert tio.read_model_manifest(root) == jio.read_model_manifest(root)
        assert tio.peek_published_fingerprint(root) == jio.peek_published_fingerprint(root) == want
        tm, tman = tio.load_published_model(root, device="cpu")
        jm, jman = jio.load_published_model(root)
        assert tman["seq"] == jman["seq"] == 2
        assert tio.model_fingerprint(tm) == jio.model_fingerprint(jm) == want


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
REFERENCE_LINE_KEYS = {"requests", "windows", "latency_p50_ms", "latency_p99_ms", "hot_hit_rate",
                       "window_occupancy_mean", "hot_budget_bytes", "snapshot_swaps", "fingerprint"}


def _published(tmp_path, seed=31, E=200):
    from photon_ml_tpu_torch.io.model_io import publish_game_model

    root = str(tmp_path / "pub")
    model = _game_model(E=E, d_fe=6, d_re=4, seed=seed)
    publish_game_model(model, root)
    return root, model


class TestDriver:
    def test_driver_json_line_through_the_umbrella(self, tmp_path, capsys):
        from photon_ml_tpu_torch.cli import main as umbrella
        from photon_ml_tpu_torch.io.model_io import model_fingerprint

        root, model = _published(tmp_path)
        umbrella.main(["serve", "--model-root", root, "--requests", "300", "--rate-hz", "20000", "--max-batch",
                       "16", "--max-wait-ms", "0.5", "--device", "cpu", "--telemetry-dir", str(tmp_path / "tel")])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert REFERENCE_LINE_KEYS <= set(line)
        assert line["requests"] == 300 and line["snapshot_swaps"] == 0 and line["device"] == "cpu"
        assert line["fingerprint"] == model_fingerprint(model)
        assert line["hot_budget_bytes"] == 200 * 4 * 4 // 4
        assert 0.0 < line["hot_hit_rate"] < 1.0 and line["windows"] >= 300 // 16
        from photon_ml_tpu_torch.obs.report import latest_run, summarize_run

        serve = summarize_run(latest_run(str(tmp_path / "tel")))["serve"]
        assert serve["requests"] == 300 and serve["windows"] == line["windows"]
        assert serve["hot_hit_rate"] == pytest.approx(line["hot_hit_rate"], abs=1e-4)

    def test_driver_requests_are_the_references(self, tmp_path):
        from photon_ml_tpu.cli.serve import _synthetic_requests as j_requests
        from photon_ml_tpu_torch.cli.serve import _synthetic_requests

        arrays = _arrays(E=50, d_fe=5, d_re=3, seed=2)
        got = _synthetic_requests(_port_model(arrays), 40, 1.0, 7)
        want = j_requests(_jax_model(arrays), 40, 1.0, 7)
        for a, b in zip(got, want):
            assert a.rid == b.rid and a.id_tags == b.id_tags
            for s in a.features:
                np.testing.assert_array_equal(a.features[s], b.features[s])

    def test_driver_serves_a_bare_model_dir(self, tmp_path):
        from photon_ml_tpu_torch.cli.serve import run
        from photon_ml_tpu_torch.io.model_io import save_game_model

        model = _game_model(E=30, d_fe=6, d_re=4, seed=3)
        save_game_model(model, str(tmp_path / "bare"))
        out = run(str(tmp_path / "bare"), requests=100, rate_hz=50000.0, device="cpu")
        assert out["fingerprint"] is None and out["requests"] == 100 and len(out["scores"]) == 100

    def test_driver_hot_swaps_a_new_publish(self, tmp_path, monkeypatch):
        """``--poll-every``: a snapshot published during the run is swapped
        in at the next slice boundary, and the slices after it score with
        the new coefficients."""
        from photon_ml_tpu_torch.cli import serve as serve_cli
        from photon_ml_tpu_torch.io.model_io import model_fingerprint, publish_game_model
        from photon_ml_tpu_torch.serve import loadgen

        root, a = _published(tmp_path, seed=41, E=20)
        b = _game_model(E=20, d_fe=6, d_re=4, seed=42)
        real, calls = loadgen.run_serve_trace, []

        def trace(store, sl, **kw):
            calls.append((store, [r.rid for r in sl]))
            out = real(store, sl, **kw)
            if len(calls) == 1:
                publish_game_model(b, root)
            return out

        monkeypatch.setattr(loadgen, "run_serve_trace", trace)
        out = serve_cli.run(root, requests=120, rate_hz=50000.0, poll_every=40, device="cpu")
        assert out["snapshot_swaps"] == 1 and out["fingerprint"] == model_fingerprint(b) and out["swap_at"] == [40]
        assert calls[0][0] is not calls[1][0] and calls[1][0] is calls[2][0]
        reqs = serve_cli._synthetic_requests(a, 120, 1.0, 0)
        got = np.asarray([out["scores"][r.rid] for r in reqs], np.float32)
        np.testing.assert_allclose(got[:40], _batch_scores(a, reqs[:40]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[40:], _batch_scores(b, reqs[40:]), rtol=1e-6, atol=1e-6)
        assert np.abs(got[40:] - _batch_scores(a, reqs[40:])).max() > 1e-3

    def test_driver_needs_cuda_unless_cpu_is_asked(self, tmp_path, monkeypatch):
        from photon_ml_tpu_torch.cli import main as umbrella

        root, _ = _published(tmp_path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            umbrella.main(["serve", "--model-root", root, "--requests", "10"])


# ---------------------------------------------------------------------------
# PHOTON_STREAM_EXECUTOR: the reference's executor branches, not ported
# ---------------------------------------------------------------------------
def _executor_consumers():
    """Each consumer the reference routes through its stream executor,
    as a zero-argument call on a tiny CPU problem."""
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, stream_scores
    from photon_ml_tpu_torch.supervised.cross_validation import cross_validate_glm
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    y = (rng.uniform(size=64) < 0.5).astype(np.float32)
    chunks = dense_chunks(X, y, 16)
    obj = StreamingGLMObjective(chunks, loss_for_task(TaskType.LOGISTIC_REGRESSION), 3, device="cpu")
    w = torch.zeros(3)
    model = _game_model(E=8)
    store = HotModelStore(model, budget_bytes=1 << 20, device="cpu")

    def serve():
        server = MicroWindowServer(store, max_batch=4, max_wait_ms=1.0, clock=_FakeClock())
        for r in _requests(model, 4, seed=1):
            server.submit(r)

    def cv():
        from photon_ml_tpu_torch.convert import dense_batch_from_numpy

        return cross_validate_glm(dense_batch_from_numpy(X, y, device="cpu"), TaskType.LOGISTIC_REGRESSION, k=2,
                                  regularization_weights=[1.0], optimizer_config=OptimizerConfig(max_iterations=3),
                                  device="cpu")

    Xe, ye = _events()
    return {
        "objective": lambda: obj.value_and_grad(w),
        "objective_scores": lambda: obj.stream_scores(w, 64),
        "scores": lambda: stream_scores(chunks, w, 64, device="cpu"),
        "cv": cv,
        "serve": serve,
        "refresh": lambda: refresh_stream(model, [("per_member", 1, Xe, ye, None, None)],
                                          OptimizerConfig(max_iterations=5), device="cpu"),
    }


@pytest.mark.parametrize("consumer", ["objective", "objective_scores", "scores", "cv", "serve", "refresh"])
def test_stream_executor_on_raises_item_9(consumer, monkeypatch):
    calls = _executor_consumers()
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        calls[consumer]()


def _bits(out):
    if isinstance(out, torch.Tensor):
        return [out.numpy().tobytes()]
    if isinstance(out, np.ndarray):
        return [out.tobytes()]
    if isinstance(out, (tuple, list)):
        return [b for o in out for b in _bits(o)]
    if hasattr(out, "models"):  # a GameModel
        return [out[c].coefficient_means.numpy().tobytes() for c in sorted(out.models)]
    if hasattr(out, "w"):
        return _bits(out.w)
    return []


@pytest.mark.parametrize("consumer", ["objective", "scores", "refresh"])
def test_stream_executor_off_is_bitwise_unset(consumer, monkeypatch):
    monkeypatch.delenv("PHOTON_STREAM_EXECUTOR", raising=False)
    unset = _bits(_executor_consumers()[consumer]())
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "0")
    off = _bits(_executor_consumers()[consumer]())
    assert unset and off == unset


def test_stream_executor_knob_parses_strictly(monkeypatch):
    from photon_ml_tpu_torch.ops.prefetch import require_stream_executor_off

    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "yes")
    with pytest.raises(ValueError):
        require_stream_executor_off("serve")
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "")
    require_stream_executor_off("serve")


# ---------------------------------------------------------------------------
# two gloo processes: cross-owner routing and a peer killed mid-step
# ---------------------------------------------------------------------------
WORKER_TIMEOUT_S = 60

_SERVE_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, port, pid, device = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from photon_ml_tpu_torch.parallel import multihost as mh

    mh.initialize_multihost(f"127.0.0.1:{port}", 2, pid, timeout_s=40)
    import test_torch_serve as t
    from photon_ml_tpu_torch.obs.metrics import REGISTRY
    from photon_ml_tpu_torch.serve.router import EntityRouter, MicroWindowServer, serve_step_collective
    from photon_ml_tpu_torch.serve.store import HotModelStore

    E, d_fe, d_re = 32, 4, 3
    arrays = t._arrays(E, d_fe, d_re, seed=0)  # the same coefficients on both processes
    model = t._port_model(arrays, device)
    store = HotModelStore(model, budget_bytes=1 << 20, device=device)
    server = MicroWindowServer(store, max_batch=8, max_wait_ms=0.0)
    weights = np.ones(E)
    weights[:4] = 50.0  # a traffic-weighted plan, the same on both processes
    router = EntityRouter(weights, 2)
    SHARDS, DIMS = ("global", "member_f"), {"global": d_fe, "member_f": d_re}

    def requests(n, seed, entities):
        reqs = t._requests(model, n, seed, entities=entities)
        for r in reqs:
            r.rid += pid * 100000
        return reqs

    ents1 = np.random.default_rng(10 + pid).integers(0, E, size=24)
    reqs1 = requests(24, 20 + pid, ents1)
    scores1 = serve_step_collective(server, router, reqs1, "member", SHARDS, shard_dims=DIMS)
    fwd = REGISTRY.snapshot("serve.")["counters"].get("serve.forwarded", {"value": 0.0})["value"]
    # the owners' windows mix both processes' requests: the batch scorer's
    # rows within float32 rounding of a dot product
    mm1 = int(not np.allclose(scores1, t._batch_scores(model, reqs1), rtol=1e-6, atol=1e-6))
    mh.allgather_obj_p2p({"pid": pid}, tag="serve_warmup")
    if pid == 1:
        print("RESULT " + json.dumps({"pid": pid, "mm1": mm1, "forwarded": fwd}), flush=True)
        # die inside the next step, after the counts but before the framed exchange
        mh._host_p2p_exchange = lambda *a, **k: os._exit(0)

    owned0 = [e for e in range(E) if router.owner_of(e) == 0]
    n2 = 48 if pid == 0 else 12
    reqs2 = requests(n2, 30 + pid, np.asarray([owned0[i % len(owned0)] for i in range(n2)], np.int64))
    peer_lost = False
    try:
        scores2 = serve_step_collective(server, router, reqs2, "member", SHARDS, shard_dims=DIMS)
    except mh.PeerLost:
        peer_lost = True
        survivors = mh.roll_call()
        assert survivors == [0], survivors
        mh.set_degraded_group(survivors)
        router.replan(weights, survivors)
        scores2 = serve_step_collective(server, router, reqs2, "member", SHARDS, shard_dims=DIMS)
    local = t._serve(HotModelStore(model, budget_bytes=1 << 20, device=device), reqs2, 8)
    print("RESULT " + json.dumps({
        "pid": pid, "mm1": mm1, "forwarded": fwd, "peer_lost": peer_lost,
        "mm2": int((t._u32(scores2) != t._u32(local)).sum()),
        "survivors": list(mh.degraded_group()["survivors"]),
        "owner_all_zero": all(router.owner_of(e) == 0 for e in range(E)),
        "giveups": REGISTRY.snapshot("p2p.")["counters"].get("p2p.giveups", {"value": 0.0})["value"],
    }), flush=True)
    os._exit(0)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_serve_drill(device: str = "cpu") -> dict:
    """The two-process drill's workers on ``device``; returns each
    worker's RESULT lines, last one wins."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_")}
    env.update(OMP_NUM_THREADS="1", PHOTON_P2P_RETRIES="1", PHOTON_P2P_BACKOFF_S="0.1", PHOTON_P2P_TIMEOUT_S="2",
               PHOTON_ROLLCALL_WINDOW_S="2")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _SERVE_WORKER, ROOT, port, str(pid), device],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for pid in range(2)]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, f"the survivor exited {procs[0].returncode}:\n{outs[0][0]}\n{outs[0][1][-6000:]}"
    results = {}
    for pid, (out, err) in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results[pid] = json.loads(line[len("RESULT "):])
    assert set(results) == {0, 1}, [o[1][-3000:] for o in outs]
    return results


def test_two_process_serve_routes_cross_owner_and_degrades_on_kill():
    """Cross-owner routing over the exchange, then a peer killed inside a
    step: the survivor's exchange raises ``PeerLost``, it degrades in place
    (roll call, survivor group, re-planned ownership) and retries the step;
    scores match the batch scorer before the loss and are bitwise the
    one-process serve path after it."""
    results = run_serve_drill("cpu")
    assert results[0]["mm1"] == 0 and results[1]["mm1"] == 0
    assert results[0]["forwarded"] + results[1]["forwarded"] > 0
    survivor = results[0]
    assert survivor["peer_lost"] is True and survivor["survivors"] == [0]
    assert survivor["mm2"] == 0 and survivor["owner_all_zero"]
    assert survivor["giveups"] >= 1.0


def test_router_replan_from_traffic_matches_the_reference():
    from photon_ml_tpu.serve.router import EntityRouter as JRouter
    from photon_ml_tpu_torch.serve.router import EntityRouter

    rng = np.random.default_rng(3)
    rows = rng.integers(1, 50, size=40).astype(np.float64)
    got, want = EntityRouter(rows, 3), JRouter(rows, 3)
    np.testing.assert_array_equal(got.owner, want.owner)
    for _ in range(3):
        ents = zipf_entity_trace(40, 500, rng=rng)
        srcs = rng.integers(0, 3, size=500)
        got.note_traffic(ents, srcs)
        want.note_traffic(ents, srcs)
        assert got.forwarded_fraction() == want.forwarded_fraction()
        assert got.replan_from_traffic() == want.replan_from_traffic()
        np.testing.assert_array_equal(got.owner, want.owner)
    assert [got.owner_of(e) for e in (-3, 41, 44)] == [want.owner_of(e) for e in (-3, 41, 44)]
    got.replan(rows, [0, 1])
    want.replan(rows, [0, 1])
    np.testing.assert_array_equal(got.owner, want.owner)
