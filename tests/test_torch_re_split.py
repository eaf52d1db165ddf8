"""The sub-bucket split, its weight axis, the device split and the
owner-segment combine (``PHOTON_RE_SPLIT``, ``PHOTON_RE_SPLIT_WEIGHT``,
``PHOTON_RE_DEVICE_SPLIT``, ``PHOTON_RE_COMBINE=segments``) in the port,
against the JAX package and against the port's knob-off arms, on the CPU.

Held to:

- the planners exactly equal to the reference's on seeded Zipf fixtures:
  the placement atoms, the split buckets and their parents, the owners
  and devices of the owned preparation, and the ``re_shard.*`` gauges;
- the in-memory owned solve on one process over ``data_mesh(2, ["cpu"])``
  bitwise the knob-off solve with the split (with and without launch
  fusion) and with the device split, and within the lane tolerance of the
  reference's same arm (the split and the device split each alone: their
  combination with the byte weight is red in the reference itself,
  ROADMAP queue 3);
- the owner-segment combine across 2 and 4 gloo processes bitwise the
  dense combine (coefficients, variances, iterations, objectives), at
  full width and projected, unsplit and split, with fewer bytes sent by
  every process;
- the streamed trainer across 2 processes with the split and the device
  split: bitwise across ranks, the device split bitwise the same fit
  without it, and within the knob-off multi-process tolerance of one
  process (a lane's bits depend on its batch on the CPU, ROADMAP queue 3).

The gloo workers are spawned as in ``tests/test_torch_re_shard.py``, whose
fixture (the reference's ``_RE_SHARD_WORKER``: 24 Zipf entities, d = 3)
these tests share.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_re_shard as rs
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.data import DenseFeatures
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.parallel import placement as tpl
from photon_ml_tpu_torch.parallel.mesh import data_mesh, process_mesh

KNOBS = ("PHOTON_RE_SHARD", "PHOTON_RE_SPLIT", "PHOTON_RE_SPLIT_WEIGHT", "PHOTON_RE_DEVICE_SPLIT",
         "PHOTON_RE_COMBINE", "PHOTON_RE_FUSE_BUCKETS", "PHOTON_RE_PROJECT")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _zipf_ids(seed: int, E: int = 300, n: int = 6000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.5, size=n) - 1, E - 1).astype(np.int64)
    return ids[rng.permutation(n)]


def _buckets(pkg, ids: np.ndarray, E: int):
    return pkg.bucket_entities(pkg.group_by_entity(ids, num_entities=E))


def _same_buckets(a, b) -> None:
    assert tuple(a.capacities) == tuple(b.capacities)
    assert len(a.entity_ids) == len(b.entity_ids)
    for x, y in zip(a.entity_ids, b.entity_ids):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(a.row_indices, b.row_indices):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("split", [0, 2, 5, 16])
@pytest.mark.parametrize("axis", ["rows", "bytes"])
def test_placement_atoms_and_split_buckets_equal_the_references(seed, split, axis):
    """``placement_atoms`` (row weights, with and without a byte axis) and
    ``split_entity_buckets`` (lane bytes, and projected widths) give the
    reference's atoms, capacities, buckets, parents and split counts."""
    import photon_ml_tpu.game.data as jdata

    E = 300
    ids = _zipf_ids(seed, E)
    counts = np.bincount(ids, minlength=E)
    active = np.minimum(counts, 40)
    byte_w = None if axis == "rows" else np.where(active > 0, 1.0 + (counts % 3), 0.0)
    got = tdata.placement_atoms(active, weights=counts, split=split, byte_weights=byte_w)
    want = jdata.placement_atoms(active, weights=counts, split=split, byte_weights=byte_w)
    assert got[1:] == tuple(want[1:])
    assert [a.tolist() for a in got[0]] == [np.asarray(a).tolist() for a in want[0]]
    tb, jb = _buckets(tdata, ids, E), _buckets(jdata, ids, E)
    dims = None if axis == "rows" else [float(4 + 2 * i) for i in range(len(tb.capacities))]
    for byte_dims in (None, dims):
        got_b, got_p, got_n = tdata.split_entity_buckets(tb, split, weight=axis, byte_dims=byte_dims)
        want_b, want_p, want_n = jdata.split_entity_buckets(jb, split, weight=axis, byte_dims=byte_dims)
        assert (got_p, got_n) == (want_p, want_n)
        _same_buckets(got_b, want_b)
    if split:
        assert got_n > 0 or axis == "rows"


def test_split_refuses_what_the_reference_refuses(monkeypatch):
    """The knob readers' strict parses, and the planners' length checks."""
    import photon_ml_tpu.parallel.placement as jpl

    for name, value in (("PHOTON_RE_SPLIT", "x"), ("PHOTON_RE_DEVICE_SPLIT", "yes"),
                        ("PHOTON_RE_SPLIT_WEIGHT", "lanes")):
        monkeypatch.setenv(name, value)
        reader = {"PHOTON_RE_SPLIT": "re_split_factor", "PHOTON_RE_DEVICE_SPLIT": "re_device_split_enabled",
                  "PHOTON_RE_SPLIT_WEIGHT": "re_split_weight"}[name]
        with pytest.raises(ValueError):
            getattr(jpl, reader)()
        with pytest.raises(ValueError):
            getattr(tpl, reader)()
        monkeypatch.delenv(name)
    monkeypatch.setenv("PHOTON_RE_SPLIT", "-3")
    assert tpl.re_split_factor() == jpl.re_split_factor() == 0
    monkeypatch.setenv("PHOTON_RE_COMBINE", "ring")
    with pytest.raises(ValueError, match="PHOTON_RE_COMBINE"):
        tre.re_combine_mode()
    with pytest.raises(ValueError):
        tdata.placement_atoms(np.ones(4), weights=np.ones(3))
    with pytest.raises(ValueError):
        tpl.plan_device_placement([1.0, 2.0], np.zeros(3, np.int64), 0, 2)
    with pytest.raises(ValueError, match="straddles"):
        tpl.plan_device_placement([1.0, 2.0, 3.0], np.array([0, 1, 0]), 0, 2, groups=[[0, 1], [2]])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("env", [
    {}, {"PHOTON_RE_SPLIT": "4"}, {"PHOTON_RE_SPLIT": "8", "PHOTON_RE_SPLIT_WEIGHT": "bytes"},
    {"PHOTON_RE_SPLIT_WEIGHT": "bytes"}, {"PHOTON_RE_DEVICE_SPLIT": "1"},
    {"PHOTON_RE_SPLIT": "6", "PHOTON_RE_DEVICE_SPLIT": "1"},
], ids=["off", "split", "split_bytes", "bytes", "device", "split_device"])
@pytest.mark.parametrize("processes", [2, 3])
def test_owned_preparation_plans_equal_the_references(seed, env, processes, monkeypatch):
    """The owned preparation's plans as each process computes them: the
    split, the process-level owners and the device-level ordinals (over
    the reference's 8 local devices), with and without projected lane
    widths, and the ``re_shard.*`` gauges they publish, equal to the
    reference's ``prepare_buckets`` helpers'."""
    import photon_ml_tpu.game.data as jdata
    import photon_ml_tpu.game.random_effect as jre
    import photon_ml_tpu.parallel.multihost as jmh
    from photon_ml_tpu.obs.metrics import REGISTRY as JREGISTRY

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    E = 300
    ids = _zipf_ids(seed, E)
    tb0, jb0 = _buckets(tdata, ids, E), _buckets(jdata, ids, E)
    monkeypatch.setattr(jmh, "effective_process_count", lambda: processes)
    for pid in range(processes):
        monkeypatch.setattr(jmh, "effective_process_index", lambda pid=pid: pid)
        for lane_dims_of in (lambda b: None, lambda b: [float(1 + c % 5) for c in b.capacities]):
            REGISTRY.reset("re_shard.")
            JREGISTRY.reset("re_shard.")
            tb, tp, tn = tdata.split_entity_buckets(tb0, tpl.re_split_factor(), weight=tpl.re_split_weight(),
                                                    byte_dims=lane_dims_of(tb0))
            jb, jp, jn = jdata.split_entity_buckets(jb0, tpl.re_split_factor(), weight=tpl.re_split_weight(),
                                                    byte_dims=lane_dims_of(jb0))
            assert (tp, tn) == (jp, jn)
            t_own = tre._plan_bucket_owners(tb, processes, pid, tp, tn, lane_dims_of(tb))
            j_own = jre._plan_bucket_owners(jb, jp, jn, lane_dims=lane_dims_of(jb))
            np.testing.assert_array_equal(t_own, j_own)
            t_dev = tre._plan_bucket_devices(tb, tp, t_own, pid, 8, lane_dims_of(tb))
            j_dev = jre._plan_bucket_devices(jb, jp, j_own, lane_dims=lane_dims_of(jb))
            assert (t_dev is None) == (j_dev is None) == ("PHOTON_RE_DEVICE_SPLIT" not in env)
            if t_dev is not None:
                np.testing.assert_array_equal(t_dev, j_dev)
            assert REGISTRY.snapshot("re_shard.")["gauges"] == JREGISTRY.snapshot("re_shard.")["gauges"]


def test_device_plan_equals_the_references_and_one_device_is_off(monkeypatch):
    """``plan_device_placement`` over groups and singletons, and its
    gauges; with one local mesh entry the device split plans nothing."""
    import photon_ml_tpu.parallel.placement as jpl
    from photon_ml_tpu.obs.metrics import REGISTRY as JREGISTRY

    rng = np.random.default_rng(5)
    counts = rng.integers(1, 100, size=40).astype(np.float64)
    owner = rng.integers(0, 3, size=40)
    groups = [[i for i in range(40) if owner[i] == p][j::4] for p in range(3) for j in range(4)]
    for g in (None, [x for x in groups if x]):
        for D in (1, 2, 5):
            for shard in range(3):
                got, gplan = tpl.plan_device_placement(counts, owner, shard, D, groups=g)
                want, wplan = jpl.plan_device_placement(counts, owner, shard, D, groups=g)
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(gplan.loads, wplan.loads)
                REGISTRY.reset("re_shard.")
                JREGISTRY.reset("re_shard.")
                tpl.record_device_placement_metrics(gplan)
                jpl.record_device_placement_metrics(wplan)
                assert REGISTRY.snapshot("re_shard.")["gauges"] == JREGISTRY.snapshot("re_shard.")["gauges"]
    monkeypatch.setenv("PHOTON_RE_DEVICE_SPLIT", "1")
    b = _buckets(tdata, _zipf_ids(0), 300)
    assert tre._plan_bucket_devices(b, None, np.zeros(len(b.capacities), np.int64), 0, 1) is None


@pytest.mark.parametrize("split", [0, 3, 8])
@pytest.mark.parametrize("override", [False, True])
def test_streamed_owner_plan_equals_the_references(split, override, monkeypatch):
    """The streamed trainer's skew-aware owner plan (``_plan_entities``:
    the global counts, the atoms of ``PHOTON_RE_SPLIT`` over the global
    capacity ladder, LPT over them, or a re-planner's forced map) equal to
    the reference's composition of the same pieces, gauges included; the
    atoms are kept for the re-planner."""
    import photon_ml_tpu.game.data as jdata
    import photon_ml_tpu.parallel.placement as jpl
    from photon_ml_tpu.obs.metrics import REGISTRY as JREGISTRY

    monkeypatch.setenv("PHOTON_RE_SPLIT", str(split))
    E, P = 300, 3
    ids = _zipf_ids(7, E)
    t = rs.StreamedGameTrainer(rs.config(), device="cpu")
    t._skew_aware = True
    c = rs.config().random_effect_coordinates["per_entity"]
    counts = np.bincount(ids, minlength=E).astype(np.int64)
    forced = np.arange(E, dtype=np.int64) % P if override else None
    REGISTRY.reset("re_shard.")
    JREGISTRY.reset("re_shard.")
    placed = t._plan_entities("per_entity", ids, E, P, 1, forced)
    atoms = None
    if split:
        atoms = jdata.placement_atoms(counts, weights=counts, capacities=c.sample_bucket_sizes,
                                      target_buckets=c.bucket_target_count,
                                      max_padded_ratio=c.bucket_max_padded_ratio, split=split)
        assert [list(a) for a in placed["atoms"]] == [np.asarray(a).tolist() for a in atoms[0]]
    else:
        assert placed["atoms"] is None
    if override:
        plan = jpl.plan_from_owner(forced, counts, P)
    elif atoms is not None:
        plan = jpl.plan_shard_placement(counts, P, groups=[list(a) for a in atoms[0]])
    else:
        plan = jpl.plan_entity_placement(counts, P)
    np.testing.assert_array_equal(placed["entity_owner"], plan.owner)
    jpl.record_placement_metrics(plan, shard=1, atoms=None if atoms is None else len(atoms[0]),
                                 split_classes=None if atoms is None else atoms[2])
    assert REGISTRY.snapshot("re_shard.")["gauges"] == JREGISTRY.snapshot("re_shard.")["gauges"]


# ---------------------------------------------------------------------------
# the in-memory owned solve on one process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def knob_off():
    f = rs.fixture()
    os.environ["PHOTON_RE_SHARD"] = "1"
    try:
        owned = tre.train_random_effects(mesh=data_mesh(2, ["cpu"]), **rs.in_memory_kwargs(f))
    finally:
        del os.environ["PHOTON_RE_SHARD"]
    return f, tre.train_random_effects(**rs.in_memory_kwargs(f)), owned


@pytest.mark.parametrize("env", [
    {"PHOTON_RE_SPLIT": "12"}, {"PHOTON_RE_SPLIT": "12", "PHOTON_RE_FUSE_BUCKETS": "1"},
    {"PHOTON_RE_SPLIT": "6", "PHOTON_RE_SPLIT_WEIGHT": "bytes"}, {"PHOTON_RE_DEVICE_SPLIT": "1"},
    {"PHOTON_RE_DEVICE_SPLIT": "1", "PHOTON_RE_FUSE_BUCKETS": "1"},
    {"PHOTON_RE_SPLIT": "12", "PHOTON_RE_DEVICE_SPLIT": "1"},
], ids=["split", "split_fused", "split_bytes", "device", "device_fused", "split_device"])
def test_owned_split_and_device_split_are_bitwise_knob_off(env, knob_off, monkeypatch):
    """One process over two CPU entries, ``PHOTON_RE_SHARD=1``: every arm
    bitwise the unsharded solve (coefficients, variances, iterations,
    objectives), each launch unit on one entry; the split's gauges count
    its atoms, the device split's its two entries; the split alone and
    the device split alone within the lane tolerance of the reference's
    same arm over its 2-shard mesh."""
    from photon_ml_tpu.parallel import data_mesh as j_data_mesh

    f, off, owned = knob_off
    np.testing.assert_array_equal(owned.coefficients.numpy(), off.coefficients.numpy())
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    REGISTRY.reset("re_shard.")
    mesh = data_mesh(2, ["cpu"])
    prepared = tre.prepare_buckets(DenseFeatures(X=torch.tensor(f["X"])), torch.tensor(f["y"]),
                                   torch.ones(f["n"]), rs.in_memory_kwargs(f)["buckets"], mesh=mesh)
    if "PHOTON_RE_SPLIT" in env:
        assert any(pb.parent is not None for pb in prepared)
    if "PHOTON_RE_DEVICE_SPLIT" in env:
        assert {pb.device for pb in prepared} == {0, 1}
        assert REGISTRY.snapshot("re_shard.")["gauges"]["re_shard.devices"] == 2.0
    got = tre.train_random_effects(mesh=mesh, **rs.in_memory_kwargs(f))
    for name in ("coefficients", "variances"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(off, name).numpy())
    np.testing.assert_array_equal(got.iterations, off.iterations)
    np.testing.assert_array_equal(got.loss_values, off.loss_values)
    if "FUSE" not in "".join(env) and not ("PHOTON_RE_SPLIT" in env and "PHOTON_RE_DEVICE_SPLIT" in env):
        np.testing.assert_allclose(got.coefficients.numpy(), rs._jax_in_memory(f, j_data_mesh(2)), **rs.LANE_TOL)


def test_a_split_launches_the_unsplit_buckets(knob_off, monkeypatch):
    """On one process the atoms of each class launch together again: as
    many lane launches as the unsplit solve, split or not, fused or not."""
    f = knob_off[0]
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    launches = {}
    for split in ("0", "12"):
        monkeypatch.setenv("PHOTON_RE_SPLIT", split)
        REGISTRY.reset("re_solve.")
        tre.train_random_effects(mesh=data_mesh(2, ["cpu"]), **rs.in_memory_kwargs(f))
        launches[split] = REGISTRY.snapshot("re_solve.")["counters"]["re_solve.launches"]["value"]
    assert launches["0"] == launches["12"] > 0


# ---------------------------------------------------------------------------
# across processes: the combine and the streamed split
# ---------------------------------------------------------------------------
_WORKER = textwrap.dedent(
    """
    import os, sys
    root, port, rank, nproc, job, work = sys.argv[1:7]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch
    torch.set_num_threads(1)
    import test_torch_re_split as t

    t.worker(job, int(port), int(rank), int(nproc), work)
    print("WORKER DONE", rank)
    """
)

COMBINE_ARMS = {
    "allreduce": {}, "segments": {"PHOTON_RE_COMBINE": "segments"},
    "split_allreduce": {"PHOTON_RE_SPLIT": "12"},
    "split_segments": {"PHOTON_RE_SPLIT": "12", "PHOTON_RE_COMBINE": "segments"},
    "project_allreduce": {"PHOTON_RE_PROJECT": "support"},
    "project_segments": {"PHOTON_RE_PROJECT": "support", "PHOTON_RE_COMBINE": "segments"},
}
STREAMED_ARMS = {
    "on": {}, "split": {"PHOTON_RE_SPLIT": "4"},
    "split_device": {"PHOTON_RE_SPLIT": "4", "PHOTON_RE_DEVICE_SPLIT": "1"},
}


def worker(job: str, port: int, rank: int, nproc: int, work: str) -> None:
    """One process of ``job`` (``combine``, ``card-combine``: the same on
    the card, or ``streamed``) in a fresh
    process group, every arm in turn; writes
    ``work/<job>-<nproc>-<rank>.npz`` and ``.json``."""
    mh.initialize_multihost(f"127.0.0.1:{port}", nproc, rank, timeout_s=120)
    arrays, out = {}, {}
    arms = STREAMED_ARMS if job == "streamed" else COMBINE_ARMS
    devices = ["cuda"] if job == "card-combine" else ["cpu"]
    for arm, env in arms.items():
        for k in [k for k in os.environ if k.startswith("PHOTON_RE_")]:
            del os.environ[k]
        os.environ.update(PHOTON_RE_SHARD="1", **env)
        REGISTRY.reset()
        if job != "streamed":
            f = rs.narrow_tail(rs.fixture()) if "project" in arm else rs.fixture()
            res = tre.train_random_effects(mesh=process_mesh(1, devices=devices), **rs.in_memory_kwargs(f))
            arrays.update({f"{arm}_W": res.coefficients.cpu().numpy(), f"{arm}_V": res.variances.cpu().numpy(),
                           f"{arm}_it": res.iterations, f"{arm}_loss": res.loss_values})
        else:
            t, W, V = rs.streamed_fit(rs.fixture(), rank, nproc,
                                      local_devices=["cpu", "cpu"] if "device" in arm else None)
            arrays.update({f"{arm}_W": W, f"{arm}_V": V})
        snap = REGISTRY.snapshot()
        out[arm] = dict(
            counters={k: v["value"] for k, v in snap["counters"].items() if k.startswith("re_combine.")},
            timers=sorted(k for k in snap["timers"] if k.startswith("re_combine.")),
            gauges={k: v for k, v in snap["gauges"].items() if k.startswith(("re_shard.", "re_combine."))})
    np.savez(os.path.join(work, f"{job}-{nproc}-{rank}.npz"), **arrays)
    with open(os.path.join(work, f"{job}-{nproc}-{rank}.json"), "w") as fh:
        json.dump(out, fh)
    mh.shutdown_multihost()


def run_workers(job: str, nproc: int, work) -> list:
    """``nproc`` gloo workers of ``job`` on a fresh port, each killed after
    the re-shard tests' limit; every rank's (arrays, metadata)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_RE_")}
    env["OMP_NUM_THREADS"] = "1"
    port = str(rs._free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, rs.ROOT, port, str(r), str(nproc), job, str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=rs.ROOT, env=env)
             for r in range(nproc)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=rs.WORKER_TIMEOUT_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0 and f"WORKER DONE {rank}" in out, f"worker {rank} failed (rc {rc}):\n{out}\n{err[-4000:]}"
    ranks = []
    for r in range(nproc):
        with open(os.path.join(work, f"{job}-{nproc}-{r}.json")) as fh:
            meta = json.load(fh)
        ranks.append((dict(np.load(os.path.join(work, f"{job}-{nproc}-{r}.npz"))), meta))
    return ranks


@pytest.mark.parametrize("nproc", [2, 4])
def test_segments_combine_is_bitwise_the_dense_combine(nproc, tmp_path):
    """``PHOTON_RE_COMBINE=segments`` across ``nproc`` gloo processes, at
    full width and projected, unsplit and split: bitwise the dense
    combine on every process (coefficients, variances, iterations,
    objectives), every process bitwise the others, fewer bytes sent by
    each, and the reference's ``re_combine.*`` names. Whole buckets stay
    bitwise one process's unsharded solve; the split's partial parents at
    the knob-off multi-process tolerance (a lane's bits depend on its
    batch on the CPU)."""
    ranks = run_workers("combine", nproc, tmp_path)
    f = rs.fixture()
    one = tre.train_random_effects(**rs.in_memory_kwargs(f))
    for arrays, meta in ranks:
        for base in ("", "split_", "project_"):
            for what in ("W", "V", "it", "loss"):
                np.testing.assert_array_equal(arrays[f"{base}segments_{what}"], arrays[f"{base}allreduce_{what}"])
                np.testing.assert_array_equal(arrays[f"{base}segments_{what}"], ranks[0][0][f"{base}segments_{what}"])
            dense = meta[f"{base}allreduce"]["counters"]["re_combine.bytes_sent"]
            seg = meta[f"{base}segments"]["counters"]["re_combine.bytes_sent"]
            assert 0 < seg < dense, (base, seg, dense)
            assert {"re_combine.exchange_s", "re_combine.wait_s"} <= set(meta[f"{base}segments"]["timers"])
            assert "re_combine.overlap_ratio" in meta[f"{base}segments"]["gauges"]
        np.testing.assert_array_equal(arrays["allreduce_W"], one.coefficients.numpy())
        np.testing.assert_allclose(arrays["split_segments_W"], one.coefficients.numpy(), **rs.ENTITY_TOL)
        assert meta["split_segments"]["gauges"]["re_shard.split_classes"] > 0


def test_streamed_split_and_device_split_across_two_processes(tmp_path, one_process_streamed):
    """The streamed trainer across 2 processes under skew-aware placement
    with ``PHOTON_RE_SPLIT=4``: atoms and split classes in the gauges, the
    same model on both ranks, the device split (two CPU entries a
    process) bitwise the same fit without it, and within the knob-off
    multi-process tolerance of one process and of the JAX package's
    one-process fit."""
    ranks = run_workers("streamed", 2, tmp_path)
    W1, jax_W = one_process_streamed
    for arrays, meta in ranks:
        for arm in STREAMED_ARMS:
            np.testing.assert_array_equal(arrays[f"{arm}_W"], ranks[0][0][f"{arm}_W"])
            np.testing.assert_allclose(arrays[f"{arm}_W"], W1, **rs.ENTITY_TOL)
            np.testing.assert_allclose(arrays[f"{arm}_W"], jax_W, **rs.ENTITY_TOL)
        np.testing.assert_array_equal(arrays["split_device_W"], arrays["split_W"])
        np.testing.assert_array_equal(arrays["split_device_V"], arrays["split_V"])
        gauges = meta["split"]["gauges"]
        assert gauges["re_shard.split_classes"] > 0 and gauges["re_shard.atoms"] > gauges["re_shard.shards"]
        assert meta["split_device"]["gauges"]["re_shard.devices"] == 2.0
        assert "re_shard.devices" not in meta["split"]["gauges"]


@pytest.fixture(scope="module")
def one_process_streamed():
    f = rs.fixture()
    _, W, _ = rs.streamed_fit(f, 0, 1)
    return W, rs.jax_one_process(f)["W"]
