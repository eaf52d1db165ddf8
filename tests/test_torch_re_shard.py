"""Entity-sharded random effects (``PHOTON_RE_SHARD``) in the port, on the
CPU: gloo workers on loopback, each spawned with ``subprocess`` on fresh
ports and killed after ``WORKER_TIMEOUT_S`` (the pattern of
``tests/test_torch_multihost_game_streaming.py``).

The fixture is the reference's (``tests/test_multihost.py``
``_RE_SHARD_WORKER``): Zipf-skewed traffic over 24 entities, one
random-effect coordinate (so every process count solves on the same
offsets), SIMPLE variances, a warm start and an incremental MAP prior, 2
outer iterations, per-visit validation with AUC and MULTI_AUC(eid). Held
to:

- the knob refusals of the in-memory solve (each knob first shows the
  fault: the reference reads it, and a port that drops it trains another
  model or silently a default; then the port raises, naming item 12d);
- the in-memory owned-bucket mode: bitwise the unsharded solve on one
  process and across 2 (coefficients, variances, iterations), each
  process staging only the buckets it owns; with the knob off a mesh keeps
  the lane-sharded schedule;
- the streamed trainer across 2 and 4 processes against one process at
  ``ENTITY_TOL``, the tolerance that holds the knob-off multi-process
  path: a lane's bits depend on the batch it rides in on the CPU
  (``test_lane_bits_depend_on_the_bucket_on_the_cpu``, ROADMAP queue 3),
  and each owner's buckets hold another subset of each capacity class;
  on the card, where they do not, bitwise (a ``cuda`` test, which also
  shows the lane floor at work); with the knob off, the legacy schedule
  (no placement gauges, blocking exchanges);
- the re-planner: a straggler (process 1's ``_solve_re_buckets`` wrapped
  with a sleep) triggers at least one re-plan that migrates entities, and
  the fit matches the fit without the straggler or the re-planner at the
  same tolerance, with the same validation history within the metric
  tolerance;
- a knob-on checkpoint resume bitwise the uninterrupted knob-on fit;
- the overlapped exchange's surface: one-process identity, a 2-process
  exchange equal to ``exchange_rows``', and two exchanges in flight while
  the main thread runs ``allgather_host``.

The port's one-process anchors, and through them every knob-on run, are
also held to the JAX package's one-process streamed fit and in-memory
solve of the same fixture (``jax_one_process``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.config import (
    GameTrainingConfig,
    OptimizationConfig,
    OptimizerConfig,
    RandomEffectCoordinateConfig,
    RegularizationContext,
)
from photon_ml_tpu_torch.game.data import DenseFeatures, bucket_entities, group_by_entity
from photon_ml_tpu_torch.game.models import GameModel, RandomEffectModel
from photon_ml_tpu_torch.game.random_effect import prepare_buckets, train_random_effects
from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.parallel.mesh import data_mesh, process_mesh
from photon_ml_tpu_torch.types import RegularizationType, TaskType, VarianceComputationType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 150
# the knob-off multi-process path's tolerance (tests/test_torch_multihost_game_streaming.py)
ENTITY_TOL = dict(rtol=5e-3, atol=1e-3)
# the lane solvers' tolerance against the JAX package (tests/test_torch_game_mesh.py)
LANE_TOL = dict(atol=2e-3, rtol=1e-2)
METRIC_TOL = 5e-3
EVALUATORS = ("AUC", "MULTI_AUC(eid)")
STRAGGLER_S = 1.0  # well above a solve here, even on a loaded machine: max / mean stays > 1.5

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, ports, rank, nproc, jobs, work = sys.argv[1:7]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch
    torch.set_num_threads(1)
    import test_torch_re_shard as t

    for port, job in zip(ports.split(","), jobs.split(",")):
        t.worker(job, int(port), int(rank), int(nproc), work)
    print("WORKER DONE", rank)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(jobs: list[str], nproc: int, work) -> None:
    """``nproc`` workers running ``jobs`` in turn, each job in a process
    group of its own on a fresh port; each worker is killed after
    ``WORKER_TIMEOUT_S`` and a failure or a timeout fails the caller."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
           and not k.startswith("PHOTON_RE_")}
    env["OMP_NUM_THREADS"] = "1"
    ports = ",".join(str(_free_port()) for _ in jobs)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, ports, str(r), str(nproc), ",".join(jobs),
                               str(work)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=env)
             for r in range(nproc)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0 and f"WORKER DONE {rank}" in out, f"worker {rank} failed (rc {rc}):\n{out}\n{err[-4000:]}"


# ---------------------------------------------------------------------------
# the fixture (the reference's _RE_SHARD_WORKER)
# ---------------------------------------------------------------------------
def fixture() -> dict:
    rng = np.random.default_rng(42)
    E = 24
    sizes = np.maximum((80.0 / (1 + np.arange(E)) ** 1.1).astype(int), 3)
    ids = np.repeat(np.arange(E), sizes).astype(np.int64)
    ids = ids[rng.permutation(len(ids))]
    n = len(ids)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    W_true = (rng.normal(size=(E, 3)) * 0.5).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-np.sum(W_true[ids] * X, axis=1)))).astype(np.float32)
    W0 = (rng.normal(size=(E, 3)) * 0.1).astype(np.float32)
    V0 = (0.5 + rng.uniform(size=(E, 3))).astype(np.float32)
    vrng = np.random.default_rng(7)
    n_val = 60
    val_ids = vrng.integers(0, E, size=n_val).astype(np.int64)
    val_ids[::15] = -1
    return dict(E=E, n=n, ids=ids, X=X, y=y, W0=W0, V0=V0, n_val=n_val, val_ids=val_ids,
                val_X=vrng.normal(size=(n_val, 3)).astype(np.float32),
                val_y=(vrng.uniform(size=n_val) < 0.5).astype(np.float32))


def config(iterations: int = 2) -> GameTrainingConfig:
    opt = OptimizationConfig(optimizer=OptimizerConfig(max_iterations=8, tolerance=1e-9),
                             regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    return GameTrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION, coordinate_update_sequence=("per_entity",),
        coordinate_descent_iterations=iterations, fixed_effect_coordinates={},
        random_effect_coordinates={"per_entity": RandomEffectCoordinateConfig("eid", "r", opt)},
        variance_computation=VarianceComputationType.SIMPLE, incremental=True,
    )


def warm_model(f: dict) -> GameModel:
    return GameModel(models={"per_entity": RandomEffectModel(
        coefficients=torch.tensor(f["W0"]), variances=torch.tensor(f["V0"]), random_effect_type="eid",
        feature_shard_id="r", task_type=TaskType.LOGISTIC_REGRESSION)}, task_type=TaskType.LOGISTIC_REGRESSION)


def split(f: dict, rank: int, nproc: int) -> tuple[StreamedGameData, StreamedGameData]:
    b = np.linspace(0, f["n"], nproc + 1).astype(int)
    vb = np.linspace(0, f["n_val"], nproc + 1).astype(int)
    lo, hi, vlo, vhi = b[rank], b[rank + 1], vb[rank], vb[rank + 1]
    return (StreamedGameData(labels=f["y"][lo:hi], features={"r": f["X"][lo:hi]}, id_tags={"eid": f["ids"][lo:hi]}),
            StreamedGameData(labels=f["val_y"][vlo:vhi], features={"r": f["val_X"][vlo:vhi]},
                             id_tags={"eid": f["val_ids"][vlo:vhi]}))


def streamed_fit(f: dict, rank: int, nproc: int, iterations: int = 2, device: str = "cpu", **kw):
    data, val = split(f, rank, nproc)
    t = StreamedGameTrainer(config(iterations), chunk_rows=1 << 16, multihost=nproc > 1, evaluators=EVALUATORS,
                            device=device, **kw)
    model, _ = t.fit(data, validation=val, initial_model=warm_model(f))
    sub = model.models["per_entity"]
    return t, sub.coefficients.cpu().numpy(), sub.variances.cpu().numpy()


def history(trainer) -> list:
    return [{cid: dict(res.metrics) for cid, res in h.items()} for h in trainer.validation_history]


def narrow_tail(f: dict) -> dict:
    """The fixture with column 2 unused by the tail entities (8 rows or
    fewer: the capacity-8 class), so their class projects."""
    X = f["X"].copy()
    X[np.bincount(f["ids"], minlength=f["E"])[f["ids"]] <= 8, 2] = 0.0
    return dict(f, X=X)


def ladder_columns(ladder: dict | None) -> dict:
    return {str(c): None if p is None else p.columns.tolist() for c, p in (ladder or {}).items()}


def in_memory_kwargs(f: dict) -> dict:
    return dict(
        features=DenseFeatures(X=torch.tensor(f["X"])), labels=f["y"], offsets=np.zeros(f["n"], np.float32),
        weights=np.ones(f["n"], np.float32), buckets=bucket_entities(group_by_entity(f["ids"], num_entities=f["E"])),
        num_entities=f["E"], loss=loss_for_task(TaskType.LOGISTIC_REGRESSION),
        config=OptimizerConfig(max_iterations=6, tolerance=1e-9), l2_weight=1.0,
        initial_coefficients=torch.tensor(f["W0"]), variance_computation=VarianceComputationType.SIMPLE,
        prior_coefficients=torch.tensor(f["W0"]), prior_variances=torch.tensor(f["V0"]), device="cpu",
    )


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------
def _registry_view() -> dict:
    snap = REGISTRY.snapshot()
    return dict(gauges={k: v for k, v in snap["gauges"].items() if k.startswith(("re_shard.", "re_replan."))},
                counters={k: v["value"] for k, v in snap["counters"].items()
                          if k.startswith(("re_replan.", "re_solve.launches", "re_combine."))},
                timers=sorted(k for k in snap["timers"] if k.startswith("re_exchange.")))


def worker(job: str, port: int, rank: int, nproc: int, work: str) -> None:
    """One process of ``job`` in a fresh process group; writes
    ``work/<job>-<nproc>-<rank>.npz`` (arrays) and ``.json``."""
    for k in [k for k in os.environ if k.startswith("PHOTON_RE_")]:
        del os.environ[k]
    REGISTRY.reset()
    mh.initialize_multihost(f"127.0.0.1:{port}", nproc, rank, timeout_s=120)
    f = fixture()
    arrays, out = {}, {}
    if job in ("on", "off"):
        os.environ["PHOTON_RE_SHARD"] = "1" if job == "on" else "0"
        calls, real = [], mh.exchange_rows

        def recording(rows, dest, tag=""):
            got = real(rows, dest, tag=tag)
            calls.append(dict(mh.LAST_EXCHANGE_STATS, tag=tag))
            return got

        mh.exchange_rows = recording
        t, W, V = streamed_fit(f, rank, nproc)
        mh.exchange_rows = real
        arrays.update(W=W, V=V)
        out.update(history=history(t), visit_stats=t.visit_stats, transports=sorted({c["transport"] for c in calls}),
                   tags=sorted({c["tag"] for c in calls}), **_registry_view())
        # the in-memory solve on the same rows, over a one-shard-a-process mesh
        mesh = process_mesh(1, devices=["cpu"])
        prepared = prepare_buckets(DenseFeatures(X=torch.tensor(f["X"])), torch.tensor(f["y"]),
                                   torch.ones(f["n"]), in_memory_kwargs(f)["buckets"], mesh=mesh)
        out["staged"] = [pb.bucket for pb in prepared if pb.static is not None]
        out["owners"] = [pb.owner for pb in prepared]
        mem = train_random_effects(mesh=mesh, **in_memory_kwargs(f))
        arrays.update(W_mem=mem.coefficients.numpy(), V_mem=mem.variances.numpy(), it_mem=mem.iterations,
                      loss_mem=mem.loss_values)
    elif job in ("card-on", "card-nofloor"):
        # on the card: knob on, and knob on with the lane floor taken away
        os.environ["PHOTON_RE_SHARD"] = "1"
        real, pads = StreamedGameTrainer._build_re_shard, []

        def recorded(self, *a, **kw):
            shard = real(self, *a, **kw)
            if shard.buckets is not None:  # a training shard
                pads.append(sum(shard.lane_floor_pad or ()))
                if job == "card-nofloor":
                    shard.lane_floor_pad = None
            return shard

        StreamedGameTrainer._build_re_shard = recorded
        try:
            t, W, V = streamed_fit(f, rank, nproc, device="cuda")
        finally:
            StreamedGameTrainer._build_re_shard = real
        arrays.update(W=W, V=V)
        out["floor_pads"] = pads
    elif job == "project":
        # skew-aware placement plans the projection ladder from allreduced counts
        os.environ["PHOTON_RE_SHARD"] = "1"
        os.environ["PHOTON_RE_PROJECT"] = "support"
        real, ladders = StreamedGameTrainer._plan_entities, []

        def recorded(self, *a, **kw):
            placed = real(self, *a, **kw)
            ladders.append(ladder_columns(placed["ladder"]))
            return placed

        StreamedGameTrainer._plan_entities = recorded
        try:
            t, W, V = streamed_fit(narrow_tail(f), rank, nproc)
        finally:
            StreamedGameTrainer._plan_entities = real
        arrays.update(W=W, V=V)
        out["ladders"] = ladders
    elif job == "replan":
        os.environ["PHOTON_RE_SHARD"] = "1"
        base, Wb, Vb = streamed_fit(f, rank, nproc, iterations=3)
        REGISTRY.reset()
        os.environ["PHOTON_RE_REPLAN_IMBALANCE"] = "1.5"
        real = StreamedGameTrainer._solve_re_buckets

        def straggler(self, *a, **kw):
            if rank == 1:
                time.sleep(STRAGGLER_S)
            return real(self, *a, **kw)

        StreamedGameTrainer._solve_re_buckets = straggler
        try:
            t, W, V = streamed_fit(f, rank, nproc, iterations=3)
        finally:
            StreamedGameTrainer._solve_re_buckets = real
        arrays.update(W=W, V=V, W_base=Wb, V_base=Vb)
        out.update(history=history(t), base_history=history(base), **_registry_view())
    elif job == "resume":
        os.environ["PHOTON_RE_SHARD"] = "1"
        full, W, V = streamed_fit(f, rank, nproc, iterations=3, checkpoint_dir=os.path.join(work, "ck_full"))
        ck = os.path.join(work, "ck_resume")
        streamed_fit(f, rank, nproc, iterations=1, checkpoint_dir=ck)
        resumed, Wr, Vr = streamed_fit(f, rank, nproc, iterations=3, checkpoint_dir=ck)
        arrays.update(W=W, V=V, W_resumed=Wr, V_resumed=Vr)
        out.update(resumed_from=resumed.resumed_from, history=history(full), resumed_history=history(resumed))
    elif job == "async":
        rng = np.random.default_rng(100 + rank)
        a = {"v": rng.normal(size=(50, 2)).astype(np.float32), "i": np.arange(50, dtype=np.int64) + 1000 * rank}
        b = {"w": rng.normal(size=(30,)).astype(np.float64)}
        da, db = rng.integers(0, nproc, size=50), rng.integers(0, nproc, size=30)
        want_a, want_b = mh.exchange_rows(a, da), mh.exchange_rows(b, db)
        h1, h2 = mh.exchange_rows_async(a, da, tag="a"), mh.exchange_rows_async(b, db, tag="b")
        gathered = mh.allgather_host(np.full(3, float(rank)))  # the main thread's collective, meanwhile
        got_a, got_b = h1.result(), h2.result()
        mh.drain_async_exchanges()
        out.update(same=all(np.array_equal(got_a[k], want_a[k]) for k in want_a)
                   and all(np.array_equal(got_b[k], want_b[k]) for k in want_b),
                   gathered=gathered.tolist(), stats=[h1.stats, h2.stats], **_registry_view())
    else:
        raise ValueError(job)
    mh.shutdown_multihost()
    tag = os.path.join(work, f"{job}-{nproc}-{rank}")
    np.savez(tag + ".npz", **arrays)
    with open(tag + ".json", "w") as fh:
        json.dump(out, fh, default=float)


def _load(work, job: str, nproc: int) -> list[dict]:
    ranks = []
    for r in range(nproc):
        tag = os.path.join(work, f"{job}-{nproc}-{r}")
        with open(tag + ".json") as fh:
            ranks.append(dict(json.load(fh), arrays=dict(np.load(tag + ".npz"))))
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("re_shard")
    _spawn(["async", "off", "on", "replan", "resume"], 2, work)
    _spawn(["on"], 4, work)
    return {(job, p): _load(work, job, p) for job, p in
            (("async", 2), ("off", 2), ("on", 2), ("replan", 2), ("resume", 2), ("on", 4))}


def jax_one_process(f: dict) -> dict:
    """The JAX package's one-process streamed fits (2 outer iterations, and
    3 as the re-plan and resume runs take) and unsharded in-memory solve of
    the fixture: the reference every knob-on run is held to."""
    import jax.numpy as jnp

    from photon_ml_tpu.config import OptimizerConfig as JOpt
    from photon_ml_tpu.config import parse_config as jparse
    from photon_ml_tpu.game.data import DenseFeatures as JDense
    from photon_ml_tpu.game.data import bucket_entities as jbucket
    from photon_ml_tpu.game.data import group_by_entity as jgroup
    from photon_ml_tpu.game.models import GameModel as JGame
    from photon_ml_tpu.game.models import RandomEffectModel as JRandomEffect
    from photon_ml_tpu.game.random_effect import train_random_effects as jtrain
    from photon_ml_tpu.game.streaming import StreamedGameData as JData
    from photon_ml_tpu.game.streaming import StreamedGameTrainer as JTrainer
    from photon_ml_tpu.ops.losses import loss_for_task as jloss
    from photon_ml_tpu.types import TaskType as JTask
    from photon_ml_tpu.types import VarianceComputationType as JVar

    warm = JGame(models={"per_entity": JRandomEffect(
        coefficients=jnp.asarray(f["W0"]), variances=jnp.asarray(f["V0"]), random_effect_type="eid",
        feature_shard_id="r", task_type=JTask.LOGISTIC_REGRESSION)}, task_type=JTask.LOGISTIC_REGRESSION)
    out = {}
    for iterations, suffix in ((2, ""), (3, "3")):
        jt = JTrainer(jparse(config(iterations).to_dict()), chunk_rows=1 << 16, evaluators=EVALUATORS)
        jm, _ = jt.fit(JData(labels=f["y"], features={"r": f["X"]}, id_tags={"eid": f["ids"]}),
                       validation=JData(labels=f["val_y"], features={"r": f["val_X"]},
                                        id_tags={"eid": f["val_ids"]}), initial_model=warm)
        sub = jm.models["per_entity"]
        out.update({f"W{suffix}": np.asarray(sub.coefficients), f"V{suffix}": np.asarray(sub.variances),
                    f"history{suffix}": history(jt)})
    kw = in_memory_kwargs(f)
    mem = jtrain(JDense(X=jnp.asarray(f["X"])), labels=f["y"], offsets=kw["offsets"], weights=kw["weights"],
                 buckets=jbucket(jgroup(f["ids"], num_entities=f["E"])), num_entities=f["E"],
                 loss=jloss(JTask.LOGISTIC_REGRESSION), config=JOpt(max_iterations=6, tolerance=1e-9), l2_weight=1.0,
                 initial_coefficients=jnp.asarray(f["W0"]), variance_computation=JVar.SIMPLE,
                 prior_coefficients=jnp.asarray(f["W0"]), prior_variances=jnp.asarray(f["V0"]))
    return dict(out, W_mem=np.asarray(mem.coefficients), V_mem=np.asarray(mem.variances))


@pytest.fixture(scope="module")
def one_process():
    """The one-process streamed fit (knob off) and the unsharded in-memory
    solve, the anchors, and the JAX package's (``jax``)."""
    f = fixture()
    t, W, V = streamed_fit(f, 0, 1)
    mem = train_random_effects(**in_memory_kwargs(f))
    return dict(W=W, V=V, history=history(t), W_mem=mem.coefficients.numpy(), V_mem=mem.variances.numpy(),
                it_mem=mem.iterations, loss_mem=mem.loss_values, jax=jax_one_process(f))


def test_the_anchors_match_the_jax_package(one_process):
    """The port's one-process fits, which the knob-on runs are held to
    bitwise or at ``ENTITY_TOL``, against the JAX package's on the same
    fixture: the streamed fit at ``ENTITY_TOL`` with the same validation
    history within the metric tolerance, the in-memory solve at the lane
    tolerance."""
    ref = one_process["jax"]
    np.testing.assert_allclose(one_process["W"], ref["W"], **ENTITY_TOL)
    np.testing.assert_allclose(one_process["V"], ref["V"], **ENTITY_TOL)
    assert len(one_process["history"]) == len(ref["history"]) == 2
    for got, want in zip(one_process["history"], ref["history"]):
        for name in EVALUATORS:
            assert abs(got["per_entity"][name] - want["per_entity"][name]) <= METRIC_TOL, name
    np.testing.assert_allclose(one_process["W_mem"], ref["W_mem"], **LANE_TOL)
    np.testing.assert_allclose(one_process["V_mem"], ref["V_mem"], **LANE_TOL)


# ---------------------------------------------------------------------------
# the knobs: the projection is ported, the 12d-iii knobs raise
# ---------------------------------------------------------------------------
def _projection_problem():
    """The fixed fault's setup, cut to size: columns 0-5 and the intercept
    active at density 0.3, Newton, l2 1.0."""
    rng = np.random.default_rng(3)
    n, d, E = 400, 16, 40
    X = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.random.default_rng(0).uniform(size=(n, d)) < 0.3
    mask[:, 6:d - 1] = False
    X = np.where(mask, X, 0.0).astype(np.float32)
    X[:, d - 1] = 1.0
    ids = rng.integers(0, E, size=n).astype(np.int64)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X[:, :6].sum(1)))).astype(np.float32)
    return X, y, ids, E, d


def _in_memory(pkg: str, X, y, ids, E, d, mesh=None):
    opt = dict(optimizer_type="NEWTON_CHOLESKY", max_iterations=20, tolerance=1e-4)
    common = dict(labels=y, offsets=np.zeros(len(y), np.float32), weights=np.ones(len(y), np.float32),
                  num_entities=E, l2_weight=1.0, intercept_index=d - 1)
    if pkg == "ref":
        import jax.numpy as jnp

        from photon_ml_tpu.config import OptimizerConfig as JOpt
        from photon_ml_tpu.game.data import DenseFeatures as JDense
        from photon_ml_tpu.game.data import bucket_entities as jbucket
        from photon_ml_tpu.game.data import group_by_entity as jgroup
        from photon_ml_tpu.game.random_effect import train_random_effects as jtrain
        from photon_ml_tpu.ops.losses import loss_for_task as jloss
        from photon_ml_tpu.types import OptimizerType as JType
        from photon_ml_tpu.types import TaskType as JTask

        res = jtrain(JDense(X=jnp.asarray(X)), buckets=jbucket(jgroup(ids, num_entities=E)),
                     loss=jloss(JTask.LOGISTIC_REGRESSION), mesh=mesh,
                     config=JOpt(optimizer_type=JType[opt["optimizer_type"]], max_iterations=20, tolerance=1e-4),
                     **common)
        return np.asarray(res.coefficients)
    from photon_ml_tpu_torch.types import OptimizerType

    res = train_random_effects(DenseFeatures(X=torch.tensor(X)), buckets=bucket_entities(group_by_entity(
        ids, num_entities=E)), loss=loss_for_task(TaskType.LOGISTIC_REGRESSION), mesh=mesh, device="cpu",
        config=OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY, max_iterations=20, tolerance=1e-4),
        **common)
    return res.coefficients.numpy()


@pytest.fixture(scope="module")
def port_knob_off():
    prob = _projection_problem()
    return prob, _in_memory("port", *prob)


@pytest.mark.parametrize("env", [{"PHOTON_RE_PROJECT": "hash", "PHOTON_RE_PROJECT_DIM": "4"},
                                 {"PHOTON_RE_PROJECT": "support"}, {"PHOTON_RE_PROJECT": "bogus"}],
                         ids=["hash", "support", "bogus"])
def test_re_project_fault_then_raise(env, port_knob_off, monkeypatch):
    """The fixed fault (the port once trained at full width where the
    reference projects each capacity class: hash folds it to another model,
    beyond the lane tolerance; support solves on the class support and
    records ``re_project.*``), then the raise that held it, are gone: the
    port now projects as the reference does, with or without a mesh
    (within the lane tolerance, the same gauges), and an unknown mode
    raises the reference's ``ValueError`` in both packages."""
    from photon_ml_tpu.obs.metrics import REGISTRY as REF_REGISTRY

    prob, W_off = port_knob_off
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    REF_REGISTRY.reset("re_project.")
    if env["PHOTON_RE_PROJECT"] == "bogus":
        with pytest.raises(ValueError):
            _in_memory("ref", *prob)
        for mesh in (None, data_mesh(2, ["cpu"])):
            with pytest.raises(ValueError, match="PHOTON_RE_PROJECT"):
                _in_memory("port", *prob, mesh=mesh)
        return
    W_ref = _in_memory("ref", *prob)
    assert REF_REGISTRY.snapshot("re_project.")["gauges"]["re_project.mean_ratio"] < 1.0
    if env["PHOTON_RE_PROJECT"] == "hash":
        assert np.abs(W_ref - W_off).max() > 2e-3  # the lane tolerance: another model
    for mesh in (None, data_mesh(2, ["cpu"])):
        REGISTRY.reset("re_project.")
        W = _in_memory("port", *prob, mesh=mesh)
        np.testing.assert_allclose(W, W_ref, **LANE_TOL)
        assert REGISTRY.snapshot("re_project.")["gauges"] == pytest.approx(
            REF_REGISTRY.snapshot("re_project.")["gauges"])


def _ref_reads(knob: str, value: str, monkeypatch) -> bool:
    """Whether the reference's owned-bucket preparation acts on the knob
    (on the same small problem), i.e. whether dropping it would change
    what the reference does."""
    import photon_ml_tpu.parallel.multihost as ref_mh
    import photon_ml_tpu.parallel.placement as ref_pl
    from photon_ml_tpu.game import random_effect as ref_re
    from photon_ml_tpu.game.data import bucket_entities as jbucket
    from photon_ml_tpu.game.data import group_by_entity as jgroup

    f = fixture()
    buckets = jbucket(jgroup(f["ids"], num_entities=f["E"]))
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    if knob == "PHOTON_RE_COMBINE":
        monkeypatch.setenv(knob, value)
        return ref_re.re_combine_mode() == value
    monkeypatch.setattr(ref_mh, "effective_process_count", lambda: 2)
    monkeypatch.setattr(ref_mh, "effective_process_index", lambda: 0)
    if knob == "PHOTON_RE_SPLIT_WEIGHT":
        rows_plan = ref_re._plan_bucket_owners(buckets)
        monkeypatch.setenv(knob, value)
        return not np.array_equal(ref_re._plan_bucket_owners(buckets), rows_plan)
    if knob == "PHOTON_RE_SPLIT":
        monkeypatch.setenv(knob, value)
        from photon_ml_tpu.game.data import split_entity_buckets

        _, parents, n_split = split_entity_buckets(buckets, ref_pl.re_split_factor())
        return parents is not None and n_split > 0
    monkeypatch.setenv(knob, value)  # PHOTON_RE_DEVICE_SPLIT: a second placement level over local devices
    owners = ref_re._plan_bucket_owners(buckets)
    return ref_re._plan_bucket_devices(buckets, None, owners) is not None


@pytest.mark.parametrize("knob, value", [("PHOTON_RE_DEVICE_SPLIT", "1"), ("PHOTON_RE_SPLIT", "12"),
                                         ("PHOTON_RE_SPLIT_WEIGHT", "bytes"), ("PHOTON_RE_COMBINE", "segments")])
def test_placement_knob_fault_then_raise_under_a_mesh(knob, value, monkeypatch):
    """The fault: under a mesh the reference acts on each of these knobs
    (a device level, sub-bucket atoms, another owner plan, another
    combine transport) and the port dropped them without a word. Now a
    mesh solve raises, naming item 12d, knob on or off; without a mesh the
    reference ignores them, and so does the port (bitwise knob-off)."""
    assert _ref_reads(knob, value, monkeypatch)
    for k in ("PHOTON_RE_SHARD", "PHOTON_RE_SPLIT", "PHOTON_RE_SPLIT_WEIGHT", "PHOTON_RE_DEVICE_SPLIT",
              "PHOTON_RE_COMBINE"):
        monkeypatch.delenv(k, raising=False)
    f = fixture()
    off = train_random_effects(**in_memory_kwargs(f))
    monkeypatch.setenv(knob, value)
    for shard_knob in ("0", "1"):
        monkeypatch.setenv("PHOTON_RE_SHARD", shard_knob)
        with pytest.raises(NotImplementedError, match="item 12d"):
            train_random_effects(mesh=data_mesh(2, ["cpu"]), **in_memory_kwargs(f))
    got = train_random_effects(**in_memory_kwargs(f))
    assert torch.equal(got.coefficients, off.coefficients) and torch.equal(got.variances, off.variances)


def test_streamed_projection_plans_one_ladder_on_every_process(tmp_path, monkeypatch):
    """``PHOTON_RE_PROJECT=support`` out of core across 2 processes under
    skew-aware placement: every process derives the same ladder from the
    allreduced counts, narrower than full width for the tail classes, and
    the fit matches one process's projected fit (which plans from its own
    rows) at ``ENTITY_TOL``, bitwise across ranks."""
    _spawn(["project"], 2, tmp_path)
    ranks = _load(tmp_path, "project", 2)
    ladders = [r["ladders"] for r in ranks]
    assert ladders[0] == ladders[1] and ladders[0]
    assert any(cols is not None and len(cols) < 3 for cols in ladders[0][0].values())
    np.testing.assert_array_equal(ranks[0]["arrays"]["W"], ranks[1]["arrays"]["W"])
    monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
    REGISTRY.reset("re_project.")
    _, W1, _ = streamed_fit(narrow_tail(fixture()), 0, 1)
    assert REGISTRY.snapshot("re_project.")["gauges"]["re_project.mean_ratio"] < 1.0
    np.testing.assert_allclose(ranks[0]["arrays"]["W"], W1, **ENTITY_TOL)


def test_streamed_trainer_raises_on_every_waiting_knob_but_re_shard(monkeypatch):
    """The 12d-iii knobs raise, naming the item; the projection, ported,
    trains (its support solve within the lane tolerance of full width:
    this fixture's classes are active in every column but one)."""
    f = fixture()
    for knob, value in (("PHOTON_RE_DEVICE_SPLIT", "1"), ("PHOTON_RE_SPLIT", "4"),
                        ("PHOTON_RE_SPLIT_WEIGHT", "bytes")):
        monkeypatch.setenv(knob, value)
        with pytest.raises(NotImplementedError, match="item 12d-iii"):
            streamed_fit(f, 0, 1)
        monkeypatch.delenv(knob)
    _, W_off, _ = streamed_fit(f, 0, 1)
    monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
    _, W, _ = streamed_fit(f, 0, 1)
    np.testing.assert_allclose(W, W_off, **LANE_TOL)


# ---------------------------------------------------------------------------
# the in-memory owned-bucket mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_owned_mesh_solve_is_bitwise_on_one_process(shards, one_process, monkeypatch):
    f = fixture()
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    REGISTRY.reset("re_shard.")
    got = train_random_effects(mesh=data_mesh(shards, ["cpu"]), **in_memory_kwargs(f))
    np.testing.assert_array_equal(got.coefficients.numpy(), one_process["W_mem"])
    np.testing.assert_array_equal(got.variances.numpy(), one_process["V_mem"])
    np.testing.assert_array_equal(got.iterations, one_process["it_mem"])
    np.testing.assert_array_equal(got.loss_values, one_process["loss_mem"])
    gauges = REGISTRY.snapshot("re_shard.")["gauges"]
    assert gauges["re_shard.shards"] == 1.0 and gauges["re_shard.balance"] == 1.0


def test_knob_off_mesh_keeps_the_lane_sharded_schedule(monkeypatch):
    """With the knob off a mesh splits each bucket's lanes over its shards,
    as before: no bucket has an owner, and the launches are one per
    (bucket, shard) with a real lane."""
    from photon_ml_tpu_torch.game import random_effect as re

    f = fixture()
    monkeypatch.delenv("PHOTON_RE_SHARD", raising=False)
    kw = in_memory_kwargs(f)
    prepared = prepare_buckets(kw["features"], torch.tensor(f["y"]), torch.ones(f["n"]), kw["buckets"],
                               mesh=data_mesh(2, ["cpu"]))
    assert all(pb.owner is None and pb.shard is not None for pb in prepared)
    re.reset_launch_counts()
    train_random_effects(mesh=data_mesh(2, ["cpu"]), **kw)
    assert re.launch_counts["launches"] == len(prepared)
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    re.reset_launch_counts()
    train_random_effects(mesh=data_mesh(2, ["cpu"]), **kw)
    assert re.launch_counts["launches"] == len(kw["buckets"].entity_ids)


def test_owned_mode_across_two_processes_is_bitwise(runs, one_process):
    """Buckets stay whole, so each solves as on one process; every row
    reaches every process by overwrite from its owner's buffer (compared
    with ``np.array_equal``, which -0.0 would pass either way). Each
    process stages only its own buckets."""
    ranks = runs[("on", 2)]
    for r in ranks:
        for key in ("W_mem", "V_mem", "it_mem", "loss_mem"):
            np.testing.assert_array_equal(r["arrays"][key], one_process[key])
            assert r["arrays"][key].tobytes() == one_process[key].tobytes(), key
        for key in ("W_mem", "V_mem"):
            np.testing.assert_allclose(r["arrays"][key], one_process["jax"][key], **LANE_TOL)
    owners = ranks[0]["owners"]
    assert owners == ranks[1]["owners"] and set(owners) == {0, 1}
    for rank, r in enumerate(ranks):
        assert r["staged"] == [b for b, o in enumerate(owners) if o == rank]


# ---------------------------------------------------------------------------
# the streamed trainer
# ---------------------------------------------------------------------------
def test_lane_bits_depend_on_the_bucket_on_the_cpu():
    """The bit contract of the streamed knob-on arm needs a lane's result
    to be independent of the other lanes of its bucket. On the CPU it is
    not, on the knob-off path already: the fixture's buckets solved whole
    and as each 2-process owner's subsets (the same capacities, the same
    offsets) give some entities other bits, by one solve's float32
    rounding (ROADMAP queue 3 pins it). Nor does the lane floor restore
    them here: a one-entity bucket padded with one all-padding lane stays
    within ``ENTITY_TOL`` of the entity leading a batch, not bitwise. On
    the card both hold (``test_streamed_knob_on_is_bitwise_one_process_on_the_card``)."""
    from photon_ml_tpu_torch.game.data import EntityBuckets
    from photon_ml_tpu_torch.game.random_effect import solve_bucket_lanes
    from photon_ml_tpu_torch.ops.batch import DenseBatch
    from photon_ml_tpu_torch.optim.common import select_minimize_fn
    from photon_ml_tpu_torch.parallel.placement import plan_entity_placement

    f = fixture()
    kw = in_memory_kwargs(f)
    full = kw["buckets"]
    whole = train_random_effects(**kw).coefficients.numpy()
    owner = plan_entity_placement(np.bincount(f["ids"], minlength=f["E"]), 2).owner
    diffs = np.zeros(f["E"])
    for p in range(2):
        keep = [[i for i, e in enumerate(es) if owner[e] == p] for es in full.entity_ids]
        sub = EntityBuckets(capacities=tuple(c for c, k in zip(full.capacities, keep) if k),
                            entity_ids=[es[k] for es, k in zip(full.entity_ids, keep) if k],
                            row_indices=[r[k] for r, k in zip(full.row_indices, keep) if k])
        own = np.flatnonzero(owner == p)
        got = train_random_effects(**dict(kw, buckets=sub)).coefficients.numpy()
        diffs[own] = np.abs(got[own] - whole[own]).max(axis=1)
    assert diffs.max() > 0.0, "every lane kept its bits: tighten the streamed knob-on arm to bitwise"
    assert diffs.max() < 1e-6 and (diffs == 0).sum() >= f["E"] - 4, diffs

    rows = full.row_indices[0]  # the capacity-8 class
    cfg = OptimizerConfig(max_iterations=8, tolerance=1e-9)
    fn, extra = select_minimize_fn(cfg, 0.0)

    def solve(lane_rows):
        idx = np.maximum(lane_rows, 0)
        mask = (lane_rows >= 0).astype(np.float32)
        b = DenseBatch(X=torch.tensor(f["X"][idx] * mask[..., None]), labels=torch.tensor(f["y"][idx] * mask),
                       offsets=torch.zeros(mask.shape), weights=torch.tensor(mask))
        return solve_bucket_lanes(b, torch.zeros(len(lane_rows), 3), torch.tensor(1.0), None, None, None,
                                  minimize_fn=fn, loss=loss_for_task(TaskType.LOGISTIC_REGRESSION), config=cfg,
                                  intercept_index=None, variance_computation=VarianceComputationType.SIMPLE, **extra)

    batched = solve(rows)
    padded = solve(np.stack([rows[0], np.full(rows.shape[1], -1, rows.dtype)]))
    for j in (0, 1, 4):  # coefficients, final objective, variances (the stopping iteration may flip)
        np.testing.assert_allclose(padded[j][0].numpy(), batched[j][0].numpy(), **ENTITY_TOL)


@pytest.mark.cuda
def test_streamed_knob_on_is_bitwise_one_process_on_the_card(tmp_path):
    """On the card a lane's bits do not depend on the other lanes of a
    batch of two or more, but a one-lane batch gives other bits. So the
    streamed knob-on fit across 2 and 4 processes (global capacity ladder,
    lane floor) is bitwise the one-process fit on the same offsets,
    coefficients and variances. Across 2 processes one owner holds a
    one-entity bucket of the 32-row class (5 entities over all processes):
    the lane floor pads it, and without the floor that entity's bits
    differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f = fixture()
    _, W, V = streamed_fit(f, 0, 1, device="cuda")
    _spawn(["card-on", "card-nofloor"], 2, tmp_path)
    _spawn(["card-on"], 4, tmp_path)
    for nproc in (2, 4):
        for r in _load(tmp_path, "card-on", nproc):
            assert r["arrays"]["W"].tobytes() == W.tobytes(), np.abs(r["arrays"]["W"] - W).max()
            assert r["arrays"]["V"].tobytes() == V.tobytes(), np.abs(r["arrays"]["V"] - V).max()
    nofloor = _load(tmp_path, "card-nofloor", 2)
    assert sum(sum(r["floor_pads"]) for r in nofloor) >= 1
    assert nofloor[0]["arrays"]["W"].tobytes() != W.tobytes()


@pytest.mark.parametrize("nproc", [2, 4])
def test_streamed_knob_on_matches_one_process(nproc, runs, one_process):
    ranks = runs[("on", nproc)]
    for r in ranks:
        # every process ends with the same model and history
        assert r["arrays"]["W"].tobytes() == ranks[0]["arrays"]["W"].tobytes()
        assert r["arrays"]["V"].tobytes() == ranks[0]["arrays"]["V"].tobytes()
        assert r["history"] == ranks[0]["history"]
        for anchor in (one_process, one_process["jax"]):
            np.testing.assert_allclose(r["arrays"]["W"], anchor["W"], **ENTITY_TOL)
            np.testing.assert_allclose(r["arrays"]["V"], anchor["V"], **ENTITY_TOL)
            assert len(r["history"]) == len(anchor["history"]) == 2
            for got, want in zip(r["history"], anchor["history"]):
                for name in EVALUATORS:
                    assert abs(got["per_entity"][name] - want["per_entity"][name]) <= METRIC_TOL, name
        # the placement and overlap instruments on every process
        g = r["gauges"]
        assert g["re_shard.shards"] == float(nproc) and g["re_shard.balance"] <= 1.5, g
        assert 0.0 <= g["re_shard.exchange_overlap_ratio"] <= 1.0
        assert r["timers"] == ["re_exchange.exchange_s", "re_exchange.wait_s"]
        visits = r["visit_stats"]
        assert len(visits) == 2 and all(v["offsets_exchange_bytes"] > 0 and "offsets_wait_s" in v for v in visits)


def test_streamed_knob_on_balances_better_than_the_modular_rule(runs):
    """The same rows under ``e % P``: the plan's balance beats it."""
    f = fixture()
    counts = np.bincount(f["ids"], minlength=f["E"]).astype(np.float64)
    for nproc in (2, 4):
        modular = np.bincount(np.arange(f["E"]) % nproc, weights=counts, minlength=nproc)
        assert runs[("on", nproc)][0]["gauges"]["re_shard.balance"] <= modular.max() / modular.mean()


def test_knob_off_keeps_the_legacy_schedule(runs, one_process):
    """The modular owners and blocking exchanges: no placement gauges, no
    overlap timers, every exchange on the default group; the launch
    counter counts one solve per owned bucket per visit."""
    for r in runs[("off", 2)]:
        assert not r["gauges"] and not r["timers"], (r["gauges"], r["timers"])
        assert r["transports"] == [mh.BACKEND] and "offsets" in r["tags"] and "scores" in r["tags"]
        assert r["counters"]["re_solve.launches"] > 0
        np.testing.assert_allclose(r["arrays"]["W"], one_process["W"], **ENTITY_TOL)
    # knob on, every visit's offsets and scores went async (one blocking
    # scores exchange remains: the warm start's, at set-up)
    assert all("offsets" not in r["tags"] for r in runs[("on", 2)])


def test_replan_migrates_on_a_straggler_and_matches(runs, one_process):
    ranks = runs[("replan", 2)]
    ref = one_process["jax"]
    for r in ranks:
        c, g = r["counters"], r["gauges"]
        assert c["re_replan.count"] >= 1 and c["re_replan.migrations"] > 0, c
        assert c["re_replan.checks"] == 2 and g["re_replan.last_imbalance"] > 1.5, (c, g)
        assert r["arrays"]["W"].tobytes() == ranks[0]["arrays"]["W"].tobytes()
        np.testing.assert_allclose(r["arrays"]["W"], r["arrays"]["W_base"], **ENTITY_TOL)
        np.testing.assert_allclose(r["arrays"]["V"], r["arrays"]["V_base"], **ENTITY_TOL)
        np.testing.assert_allclose(r["arrays"]["W"], ref["W3"], **ENTITY_TOL)
        np.testing.assert_allclose(r["arrays"]["V"], ref["V3"], **ENTITY_TOL)
        assert len(r["history"]) == len(r["base_history"]) == len(ref["history3"]) == 3
        for got, want, jax_want in zip(r["history"], r["base_history"], ref["history3"]):
            for name in EVALUATORS:
                assert abs(got["per_entity"][name] - want["per_entity"][name]) <= METRIC_TOL, name
                assert abs(got["per_entity"][name] - jax_want["per_entity"][name]) <= METRIC_TOL, name


def test_replan_is_off_by_default_and_on_one_process(monkeypatch):
    """Threshold 0 (the default), or one process: no check, no collective."""
    f = fixture()
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    for threshold in (None, "1.01"):
        if threshold is not None:
            monkeypatch.setenv("PHOTON_RE_REPLAN_IMBALANCE", threshold)
        REGISTRY.reset("re_replan.")
        streamed_fit(f, 0, 1, iterations=3)
        assert not REGISTRY.snapshot("re_replan.")["counters"]


def test_knob_on_resume_is_bitwise_the_uninterrupted_fit(runs, one_process):
    for r in runs[("resume", 2)]:
        assert tuple(r["resumed_from"]) == (1, 0)
        assert r["arrays"]["W_resumed"].tobytes() == r["arrays"]["W"].tobytes()
        assert r["arrays"]["V_resumed"].tobytes() == r["arrays"]["V"].tobytes()
        assert r["resumed_history"] == r["history"][1:]
        np.testing.assert_allclose(r["arrays"]["W"], one_process["jax"]["W3"], **ENTITY_TOL)
        np.testing.assert_allclose(r["arrays"]["V"], one_process["jax"]["V3"], **ENTITY_TOL)


# ---------------------------------------------------------------------------
# the overlapped exchange's surface
# ---------------------------------------------------------------------------
def test_async_exchange_on_one_process_is_the_identity():
    REGISTRY.reset("re_")
    a = {"v": np.arange(6, dtype=np.float32).reshape(3, 2)}
    h = mh.exchange_rows_async(a, np.zeros(3, np.int64), tag="solo")
    assert h.done and np.array_equal(h.result()["v"], a["v"]) and h.stats["bytes_sent"] == 0
    mh.drain_async_exchanges()
    assert REGISTRY.snapshot("re_shard.")["gauges"]["re_shard.exchange_overlap_ratio"] == 1.0


def test_async_exchanges_equal_the_blocking_ones_beside_a_main_thread_collective(runs):
    """Two exchanges in flight on the exchange worker while the main thread
    runs ``allgather_host`` on the default group: neither hangs (each
    worker is killed after its limit) nor mixes payloads."""
    for r in runs[("async", 2)]:
        assert r["same"]
        assert r["gathered"] == [[0.0] * 3, [1.0] * 3]
        assert [s["transport"] for s in r["stats"]] == [f"{mh.BACKEND}_async"] * 2
        assert all(s["bytes_sent"] > 0 and s["seconds"] >= 0.0 for s in r["stats"])
        assert r["timers"] == ["re_exchange.exchange_s", "re_exchange.wait_s"]


def test_pending_exchange_joins_once_under_contention():
    """The offsets exchange is joined by whichever bucket gather runs
    first, on prefetch workers: many threads joining one handle (a short
    switch interval, more threads than cores) wait on it and run its
    epilogue once, and the trainer books it once; the overlap books lose
    no update."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    class SlowFuture:
        def result(self):
            time.sleep(0.01)
            return {"x": np.arange(3)}, {"seconds": 0.5, "bytes_sent": 7}

        def done(self):
            return False

    finished = []
    handle = mh.ExchangeHandle(future=SlowFuture(), tag="t",
                               finish=lambda recv, stats: finished.append(stats) or recv["x"].sum())
    trainer = StreamedGameTrainer(config(), device="cpu")
    solo = trainer._exchange_async("offsets", {"x": np.arange(4)}, np.zeros(4, np.int64), "offsets",
                                   lambda recv: recv["x"].sum())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            got = list(pool.map(lambda _: handle.result(), range(64), timeout=60))
            got_solo = list(pool.map(lambda _: solo.result(), range(64), timeout=60))
        before = dict(mh._EXCHANGE_TOTALS)
        threads = [threading.Thread(target=lambda: [mh._record_overlap("exchange_s", 1.0) for _ in range(200)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    after = mh._EXCHANGE_TOTALS["exchange_s"]
    mh._EXCHANGE_TOTALS.update(before)
    assert got == [3] * 64 and len(finished) == 1 and finished[0]["wait_s"] >= 0.01
    assert handle.stats == dict(seconds=0.5, bytes_sent=7, wait_s=finished[0]["wait_s"])
    assert got_solo == [6] * 64
    assert trainer.exchange_totals == {"offsets": {"seconds": 0.0, "bytes": 0, "calls": 1, "wait_s": 0.0}}
    assert after - before["exchange_s"] == 3200.0
