"""Two-process fault drills of the port on the CPU (gloo over loopback,
the framed mesh between the processes), after the reference's chaos drills
(``tests/test_multihost.py`` ``test_peer_kill_recovers_from_checkpoint_bitwise``
and ``test_descent_peer_kill_degrades_in_place_bitwise``), with the same
fixtures and fault plans:

- the streamed peer kill: process 1 dies at its second visit's offsets
  send (link 1→0, frame set 3, tag ``offsets``); process 0's retries
  exhaust into ``PeerLost``, the roll call confirms the loss, the group
  degrades to process 0 and the fit resumes from the last checkpoint,
  bitwise a clean one-process fit over process 0's rows resumed from the
  same (anchor) checkpoint, its scores sliced to those rows by the test;
- the writer's loss: of two processes, process 1 alone may not go on (the
  roll call's split-brain rule) and aborts; of three, processes 1 and 2
  resume at their bases n/3 and 2n/3 of the old layout, process 1 reading,
  broadcasting and writing the checkpoints, bitwise two processes' fit
  over their rows resumed from the anchor sliced to them;
- the descent peer kill: process 1 dies at its first owner-segment combine
  send of a resumed in-memory descent (``PHOTON_RE_SHARD=1``,
  ``PHOTON_RE_COMBINE=segments``, ``PHOTON_DESCENT_DEGRADE=1``); ``run``
  returns normally on process 0, bitwise a clean one-process descent
  resumed from the same iteration state;
- the ring on a healthy group: a streamed fit with the reliable mode and
  CRC armed and no plan is bitwise the knob-off fit, which carries no CRC
  trailer and no completion ACK;
- a skewed exchange on the mesh: the rows the gloo route delivers.

Every worker is killed after ``WORKER_TIMEOUT_S``; a killed process must
exit 137 and only the one the plan names may. The roll call's window is
1.5 s and the mesh's timeout 2 s, so no test waits on a gloo timeout.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 50
E = 12
GROUPS = 3
FAULT_ENV = {"PHOTON_P2P_CRC": "1", "PHOTON_P2P_RETRIES": "2", "PHOTON_P2P_BACKOFF_S": "0.1",
             "PHOTON_P2P_TIMEOUT_S": "2", "PHOTON_ROLLCALL_WINDOW_S": "1.5"}
STREAMED_KILL = [{"op": "kill", "link": [1, 0], "seq": 3, "tag": "offsets"}]
DESCENT_KILL = [{"op": "kill", "link": [1, 0], "seq": 1, "tag": "re_combine/wv"}]

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, port, rank, nproc, job, work, mode = sys.argv[1:8]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch
    torch.set_num_threads(1)
    import test_torch_faults_drill as t

    t.worker(job, int(port), int(rank), int(nproc), work, json.loads(mode))
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(job: str, nproc: int, work, mode: dict, env: dict | None = None, allow_kill=(),
                expect_fail=()) -> dict:
    """``nproc`` workers of ``job`` in one process group on a fresh port;
    each is killed after ``WORKER_TIMEOUT_S``. A worker in ``allow_kill``
    must exit 137 (the plan's kill), one in ``expect_fail`` 1 (an uncaught
    error), every other 0. Returns each finished rank's (arrays, meta), and
    each failed rank's standard error."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("PHOTON_") and k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                                                          "JAX_PROCESS_ID")}
    base.update(OMP_NUM_THREADS="1", **(env or {}))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, port, str(r), str(nproc), job, str(work),
                               json.dumps(mode)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=base)
             for r in range(nproc)]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    done = {}
    for rank, (rc, out, err) in enumerate(results):
        want = 137 if rank in allow_kill else 1 if rank in expect_fail else 0
        assert rc == want, f"worker {rank} exited {rc}, expected {want}:\n{out}\n{err[-4000:]}"
        if rc == 1:
            done[rank] = err
        elif rc == 0:
            with open(os.path.join(work, f"{job}-{rank}.json")) as fh:
                meta = json.load(fh)
            done[rank] = (dict(np.load(os.path.join(work, f"{job}-{rank}.npz"))), meta)
    return done


def _entity_fixture(sizes: np.ndarray):
    """The reference drills' fixture: E entities of ``sizes`` rows in a
    seeded order, 3 features, logistic labels."""
    rng = np.random.default_rng(42)
    ids = np.repeat(np.arange(E), sizes).astype(np.int64)
    ids = ids[rng.permutation(len(ids))]
    n = len(ids)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    W_true = (rng.normal(size=(E, 3)) * 0.5).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-np.sum(W_true[ids] * X, axis=1)))).astype(np.float32)
    return ids, X, y


def _counters() -> dict:
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    snap = REGISTRY.snapshot()
    return {k: v["value"] for k, v in snap["counters"].items() if k.startswith(("p2p.", "fleet."))}


def _opt():
    from photon_ml_tpu_torch.config import OptimizationConfig, OptimizerConfig, RegularizationContext
    from photon_ml_tpu_torch.types import RegularizationType

    return OptimizationConfig(optimizer=OptimizerConfig(max_iterations=6, tolerance=1e-9),
                              regularization=RegularizationContext(RegularizationType.L2),
                              regularization_weight=1.0)


def _row_slices(n: int, nproc: int) -> list[list[int]]:
    """Contiguous equal row ranges, one a process."""
    per = n // nproc
    return [[r * per, (r + 1) * per] for r in range(nproc)]


def streamed_fit(rank: int, nproc: int, mode: dict):
    """The reference's chaos worker: uniform entity sizes (the ingest stays
    on gloo, so the mesh's frame sets are exactly offsets = 1, scores = 2 a
    visit); process r holds ``mode["rows"][r]`` (by default an equal
    contiguous share a process)."""
    from photon_ml_tpu_torch.checkpoint import peek_fingerprint
    from photon_ml_tpu_torch.config import GameTrainingConfig, RandomEffectCoordinateConfig
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
    from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

    ids, X, y = _entity_fixture(np.full(E, 6))
    lo, hi = mode.get("rows", _row_slices(len(ids), nproc))[rank]
    coords = {"per_entity": RandomEffectCoordinateConfig(random_effect_type="eid", feature_shard_id="r",
                                                         optimization=_opt())}
    tags = {"eid": ids[lo:hi]}
    if mode.get("groups"):
        # a second random effect over groups of entities: each visit's
        # offsets are the other's scores, so a resume's score slice counts
        coords["per_group"] = RandomEffectCoordinateConfig(random_effect_type="gid", feature_shard_id="r",
                                                           optimization=_opt())
        tags["gid"] = ids[lo:hi] % GROUPS
    cfg = GameTrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION, coordinate_update_sequence=tuple(coords),
        coordinate_descent_iterations=mode.get("iterations", 2), fixed_effect_coordinates={},
        random_effect_coordinates=coords, variance_computation=VarianceComputationType.SIMPLE)
    data = StreamedGameData(labels=y[lo:hi], features={"r": X[lo:hi]}, id_tags=tags)
    trainer = StreamedGameTrainer(cfg, chunk_rows=1 << 16, multihost=nproc > 1,
                                  checkpoint_dir=mode.get("checkpoint_dir"), num_entities={"eid": E, "gid": GROUPS},
                                  sharded_checkpoints=False, device=mode.get("device", "cpu"))
    if mode.get("resume_fingerprint_from"):
        fp = peek_fingerprint(mode["resume_fingerprint_from"])
        assert fp is not None
        trainer.resume_fingerprints = [fp]
        if "resume_row_base" in mode:
            trainer.resume_row_base = int(mode["resume_row_base"])
    model, _ = trainer.fit(data)
    return trainer, model


def descent_run(nproc: int, mode: dict):
    """The reference's descent worker: every process holds every row (the
    in-memory schedule splits bucket ownership only), one random effect
    over a process mesh of one CPU shard a process."""
    from photon_ml_tpu_torch.game import CoordinateDescent, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity, make_game_batch
    from photon_ml_tpu_torch.parallel.mesh import process_mesh
    from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

    ids, X, y = _entity_fixture(np.maximum((60.0 / (1 + np.arange(E)) ** 1.1).astype(int), 3))
    batch = make_game_batch(y, {"r": X}, id_tags={"eid": ids}, device="cpu")
    grouping = group_by_entity(ids, num_entities=E)
    coord = RandomEffectCoordinate(
        coordinate_id="per_entity", batch=batch, feature_shard_id="r", random_effect_type="eid",
        config=_opt(), grouping=grouping, buckets=bucket_entities(grouping),
        task_type=TaskType.LOGISTIC_REGRESSION, num_entities=E,
        variance_computation=VarianceComputationType.SIMPLE,
        mesh=process_mesh(1, devices=["cpu"]) if nproc > 1 else None)
    cd = CoordinateDescent(coordinates={"per_entity": coord}, batch=batch, task_type=TaskType.LOGISTIC_REGRESSION)
    res = cd.run(["per_entity"], int(mode.get("iterations", 3)), checkpoint_dir=mode.get("checkpoint_dir"),
                 checkpoint_fingerprint=mode.get("fingerprint"),
                 resume_fingerprints=mode.get("resume_fingerprints", []))
    sub = res.model.models["per_entity"]
    return res, sub.coefficients.numpy(), sub.variances.numpy()


def worker(job: str, port: int, rank: int, nproc: int, work: str, mode: dict) -> None:
    """One process of ``job`` (``streamed``, ``descent``, ``exchange``);
    writes ``work/<job>-<rank>.npz`` and ``.json``, then leaves at once: a
    degraded survivor must not wait on the dead peer at interpreter exit."""
    from photon_ml_tpu_torch.parallel import multihost as mh

    if mode.get("fault_plan"):
        os.environ["PHOTON_FAULT_PLAN"] = json.dumps(mode["fault_plan"])
    if mode.get("degrade"):
        os.environ["PHOTON_DESCENT_DEGRADE"] = "1"
    if nproc > 1:
        mh.initialize_multihost(f"127.0.0.1:{port}", nproc, rank, timeout_s=45)
    arrays, meta = {}, {}
    if job == "streamed":
        t, model = streamed_fit(rank, nproc, mode)
        for cid, sub in model.models.items():
            key = "" if cid == "per_entity" else f"_{cid}"
            arrays.update({f"W{key}": sub.coefficients.cpu().numpy(), f"V{key}": sub.variances.cpu().numpy()})
        meta.update(resumed_from=list(t.resumed_from) if t.resumed_from is not None else None,
                    frame_sets_sent={str(k): v for k, v in mh._LINK_SEQ["send"].items()})
    elif job == "descent":
        res, W, V = descent_run(nproc, mode)
        arrays.update(W=W, V=V)
        meta.update(iterations_recorded=len(res.trackers["per_entity"]))
    else:  # a skewed exchange: on the mesh by the rule, and the gloo route forced
        rng = np.random.default_rng(rank)
        n = 40 if rank == 0 else 10
        rows = {"gid": np.arange(n, dtype=np.int64) + 1000 * rank, "x": rng.normal(size=(n, 3)).astype(np.float32)}
        # counts [[37, 3], [10, 0]]: P² × 37 > 2 × 50, one block holds most of the payload
        dest = np.zeros(n, np.int64)
        dest[:3] = 1 - rank
        got = mh.exchange_rows(rows, dest, tag="skew")
        meta["transport"] = mh.LAST_EXCHANGE_STATS["transport"]
        counts = mh.allgather_host(np.bincount(dest, minlength=nproc)).reshape(nproc, nproc)
        order = np.argsort(dest, kind="stable")
        ref, _, _ = mh._exchange_on({k: np.ascontiguousarray(v) for k, v in rows.items()}, order,
                                    np.bincount(dest, minlength=nproc), counts, "skew")
        arrays.update(ring_gid=got["gid"], ring_x=got["x"], gloo_gid=ref["gid"], gloo_x=ref["x"])
    meta["counters"] = _counters()
    np.savez(os.path.join(work, f"{job}-{rank}.npz"), **arrays)
    with open(os.path.join(work, f"{job}-{rank}.json"), "w") as fh:
        json.dump(meta, fh)
    sys.stdout.flush()
    os._exit(0)


def _slice_checkpoint(src, dst, lo: int, hi: int, rows: list[int]) -> None:
    """``src``'s gathered checkpoint with its scores and total cut to the
    global rows [lo, hi) by numpy, its data digest that of the fixture's
    rows [rows[0], rows[1]) (the process that reads it first), written to
    ``dst``: the survivors' resume state, sliced apart from the trainer."""
    from photon_ml_tpu_torch.checkpoint import _META_KEY, _SCORE_PREFIX, _TOTAL_KEY
    from photon_ml_tpu_torch.game.streaming import _host_digest

    with np.load(src / "ckpt.npz") as z:
        arrays = {k: z[k] for k in z.files}
    for k in arrays:
        if k.startswith(_SCORE_PREFIX) or k == _TOTAL_KEY:
            assert arrays[k].shape[0] > hi - 1
            arrays[k] = arrays[k][lo:hi].copy()
    meta = json.loads(bytes(arrays[_META_KEY]).decode())
    _, _, y = _entity_fixture(np.full(E, 6))
    meta["data_digest"] = _host_digest(y[rows[0]:rows[1]], np.ones(rows[1] - rows[0], np.float32))
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    dst.mkdir()
    np.savez(dst / "ckpt.npz", **arrays)


def check_streamed_peer_kill(tmp_path, device: str = "cpu", killed: int = 1, nproc: int = 2,
                             groups: bool = False) -> None:
    """The streamed drill on ``device`` (the card test runs it on CUDA):
    ``nproc`` processes, process ``killed`` dies at its first offsets send
    of the second outer iteration to the next process (each visit sends
    one offsets and one scores frame set a link; ``groups`` adds a second
    random effect). The survivors' model is held bitwise to a clean fit of
    as many processes over the survivors' rows, resumed from the anchor
    checkpoint whose scores the test sliced to those rows
    (``_slice_checkpoint``), so the survivors' own slicing at their bases
    before the loss is checked against an independent one."""
    anchor, chaos, clean_dir = tmp_path / "anchor", tmp_path / "chaos", tmp_path / "clean"
    n = E * 6
    survivors = [r for r in range(nproc) if r != killed]
    env = dict(FAULT_ENV, PHOTON_RE_SHARD="1")
    # the anchor: a clean fit of one outer iteration writes the checkpoint
    # the chaos fit writes before the kill
    run_workers("streamed", nproc, tmp_path, {"iterations": 1, "checkpoint_dir": str(anchor), "device": device,
                                              "groups": groups}, env=env)
    assert (anchor / "ckpt.npz").exists()
    seq = 2 * (2 if groups else 1) + 1
    plan = [{"op": "kill", "link": [killed, (killed + 1) % nproc], "seq": seq, "tag": "offsets"}]
    chaos_ranks = run_workers("streamed", nproc, tmp_path, {"iterations": 2, "checkpoint_dir": str(chaos),
                                                            "fault_plan": plan, "device": device, "groups": groups},
                              env=env, allow_kill=(killed,))
    assert sorted(chaos_ranks) == survivors
    for r in survivors:
        arrays, meta = chaos_ranks[r]
        assert meta["resumed_from"] == [1, 0]
        for name in ("fleet.peer_lost", "fleet.recoveries", "p2p.giveups"):
            assert meta["counters"].get(name) == 1.0, (r, meta["counters"])
        for k in arrays:
            assert arrays[k].tobytes() == chaos_ranks[survivors[0]][0][k].tobytes()
    # the lowest survivor wrote the degraded group's checkpoints: the last
    # is the end of the fit under the survivors' layout
    with np.load(chaos / "ckpt.npz") as z:
        from photon_ml_tpu_torch.checkpoint import _META_KEY

        last = json.loads(bytes(z[_META_KEY]).decode())
    from photon_ml_tpu_torch.checkpoint import peek_fingerprint

    assert last["next_iteration"] == 2 and last["fingerprint"] != peek_fingerprint(str(anchor))
    # the clean arm: the survivors' rows (contiguous), resumed from the
    # anchor sliced to them, with the anchor's fingerprint and no row base
    rows = [_row_slices(n, nproc)[r] for r in survivors]
    _slice_checkpoint(anchor, clean_dir, rows[0][0], rows[-1][1], rows[0])
    clean = run_workers("streamed", len(survivors), tmp_path,
                        {"iterations": 2, "checkpoint_dir": str(clean_dir), "device": device, "rows": rows,
                         "resume_fingerprint_from": str(anchor), "groups": groups}, env=env)
    for r, s_ in enumerate(survivors):
        clean_arrays, meta = clean[r]
        assert meta["resumed_from"] == [1, 0]
        assert sorted(clean_arrays) == sorted(chaos_ranks[s_][0])
        for k, v in clean_arrays.items():
            assert chaos_ranks[s_][0][k].tobytes() == v.tobytes(), k


def test_streamed_peer_kill_recovers_from_checkpoint_bitwise(tmp_path):
    check_streamed_peer_kill(tmp_path)


def test_streamed_kill_of_the_writer_of_two_aborts_the_survivor(tmp_path):
    """Process 0, the writer, dies in a group of two: process 1 is exactly
    half the group without the writer, so its roll call aborts the fit
    (no second writer), and the checkpoint stays the one process 0 wrote
    after the first outer iteration."""
    from photon_ml_tpu_torch.checkpoint import _META_KEY

    chaos = tmp_path / "chaos"
    plan = [{"op": "kill", "link": [0, 1], "seq": 3, "tag": "offsets"}]
    ranks = run_workers("streamed", 2, tmp_path, {"iterations": 2, "checkpoint_dir": str(chaos), "fault_plan": plan},
                        env=dict(FAULT_ENV, PHOTON_RE_SHARD="1"), allow_kill=(0,), expect_fail=(1,))
    assert "without a strict member majority" in ranks[1] and "writer, process 0" in ranks[1]
    with np.load(chaos / "ckpt.npz") as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
    assert (meta["next_iteration"], meta["next_coordinate"]) == (1, 0)


def test_streamed_kill_of_the_writer_of_three_moves_the_writer_and_broadcast(tmp_path):
    """Three processes, process 0 dies: processes 1 and 2 go on as a
    degraded group, process 1 reads and broadcasts the checkpoint and
    writes the next ones, each survivor slices the gathered scores at its
    base (n/3, 2n/3) there. Two random effects, so that each visit's
    offsets are the sliced scores of the other."""
    check_streamed_peer_kill(tmp_path, killed=0, nproc=3, groups=True)


def test_descent_peer_kill_degrades_in_place_bitwise(tmp_path):
    import shutil

    anchor, chaos, clean_dir = tmp_path / "anchor", tmp_path / "chaos", tmp_path / "clean"
    env = dict(FAULT_ENV, PHOTON_RE_SHARD="1", PHOTON_RE_COMBINE="segments")
    run_workers("descent", 2, tmp_path, {"iterations": 1, "checkpoint_dir": str(anchor),
                                         "fingerprint": "descent-p2", "degrade": True}, env=env)
    assert (anchor / "ckpt.npz").exists()
    shutil.copytree(anchor, chaos)
    shutil.copytree(anchor, clean_dir)
    chaos_ranks = run_workers(
        "descent", 2, tmp_path, {"iterations": 3, "checkpoint_dir": str(chaos), "fingerprint": "descent-p2",
                                 "degrade": True, "fault_plan": DESCENT_KILL}, env=env, allow_kill=(1,))
    surv_arrays, surv = chaos_ranks[0]
    # degraded in place: one tracker a resumed iteration, no re-entry
    assert surv["iterations_recorded"] == 2
    assert surv["counters"].get("fleet.peer_lost") == 1.0
    assert surv["counters"].get("fleet.degraded_descents") == 1.0
    assert "fleet.recoveries" not in surv["counters"]
    (clean_arrays, _), = run_workers(
        "descent", 1, tmp_path, {"iterations": 3, "checkpoint_dir": str(clean_dir), "fingerprint": "descent-p1",
                                 "resume_fingerprints": ["descent-p2"]}).values()
    assert surv_arrays["W"].tobytes() == clean_arrays["W"].tobytes()
    assert surv_arrays["V"].tobytes() == clean_arrays["V"].tobytes()


def test_ring_on_a_healthy_group_is_bitwise_the_knob_off_fit(tmp_path):
    """CRC and the reliable mode armed, no plan: the same bits as with every
    fault knob unset, and no recovery counter moves."""
    (tmp_path / "off").mkdir()
    (tmp_path / "armed").mkdir()
    off = run_workers("streamed", 2, tmp_path / "off", {"iterations": 2}, env={"PHOTON_RE_SHARD": "1"})
    armed = run_workers("streamed", 2, tmp_path / "armed", {"iterations": 2}, env=dict(FAULT_ENV, PHOTON_RE_SHARD="1"))
    for r in range(2):
        assert off[r][0]["W"].tobytes() == armed[r][0]["W"].tobytes()
        assert off[r][0]["V"].tobytes() == armed[r][0]["V"].tobytes()
        assert not off[r][1]["counters"] and not armed[r][1]["counters"]
    assert off[0][0]["W"].tobytes() == off[1][0]["W"].tobytes()


def test_skewed_exchange_rides_the_mesh_with_the_gloo_route_s_rows(tmp_path):
    ranks = run_workers("exchange", 2, tmp_path, {})
    for r in range(2):
        arrays, meta = ranks[r]
        assert meta["transport"] == "p2p_host"
        assert arrays["ring_gid"].tobytes() == arrays["gloo_gid"].tobytes()
        assert arrays["ring_x"].tobytes() == arrays["gloo_x"].tobytes()
    # process 0 receives its own 37 rows and process 1's 10; process 1 the 3 sent to it
    assert len(ranks[0][0]["ring_gid"]) == 47 and len(ranks[1][0]["ring_gid"]) == 3
