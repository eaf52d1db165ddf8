"""Elastic-rejoin drills of the port on the CPU (gloo over loopback, the
framed mesh between the processes), after the reference's
(``tests/test_multihost.py`` ``test_rejoin_after_kill_bitwise_with_four_processes``
and ``test_rejoin_races_degrade_roll_call``), on the fixture of
``tests/test_torch_faults_drill.py``:

- four processes, process 3 dies at its second visit's offsets send (link
  3→0, frame set 3) with the fault op ``rejoin`` and re-execs 2 s later as
  a rejoin boot (``multihost.bootstrap_rejoin`` from the mesh cache,
  never ``initialize_multihost``). The survivors degrade to [0, 1, 2],
  re-enter the fit, and at the first visit boundary admit process 3 back
  and resume from the checkpoint written before the loss: every process's
  model is bitwise an uninterrupted four-process run, ``fleet.rejoins`` is
  1 on every process and the ``rejoin`` records name both roles;
- the race: the rejoiner comes back 0.2 s after its death while a delay
  stalls one survivor's discovery of the loss, so the degrade roll call
  dials the rejoiner's address; the rejoiner ignores that dial, the degrade
  goes on without it and a boundary admits it, bitwise as before.

Each worker is killed after ``WORKER_TIMEOUT_S``, the rejoiner too (it
runs in a session of its own and records its pid for that).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_faults_drill as drill  # noqa: E402

# a loss costs the retries' dials, a 10 s roll call and a re-entry; the
# rejoiner's boot and the admission's roll call come on top
WORKER_TIMEOUT_S = 150
NPROC = 4
REJOIN_ENV = {"PHOTON_RE_SHARD": "1", "PHOTON_P2P_CRC": "1", "PHOTON_P2P_RETRIES": "2",
              "PHOTON_P2P_BACKOFF_S": "0.1", "PHOTON_P2P_TIMEOUT_S": "3", "PHOTON_ROLLCALL_WINDOW_S": "10",
              "PHOTON_COORD_MAX_MISSING_HEARTBEATS": "12"}
KILL_AND_REJOIN = [{"op": "rejoin", "link": [3, 0], "seq": 3, "tag": "offsets", "delay_s": 2.0}]
RACE = [{"op": "rejoin", "link": [3, 0], "seq": 3, "tag": "offsets", "delay_s": 0.2},
        # process 0's second offsets send to process 1 stalls, so process 1
        # enters the roll call late while process 3's listener comes up
        {"op": "delay", "link": [0, 1], "seq": 3, "tag": "offsets", "delay_s": 1.5}]

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, port, rank, nproc, work, mode = sys.argv[1:7]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch
    torch.set_num_threads(1)
    import test_torch_rejoin_drill as t

    t.worker(int(port), int(rank), int(nproc), work, json.loads(mode))
    """
)


def worker(port: int, rank: int, nproc: int, work: str, mode: dict) -> None:
    """One process of the drill: joins the gloo group, or, re-exec'd by the
    ``rejoin`` op (``PHOTON_REJOIN_BOOT``), takes its original identity from
    the mesh cache; fits ``drill.streamed_fit``; writes
    ``work/streamed-<rank>.npz`` and ``.json`` and leaves at once."""
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.parallel import multihost as mh

    if os.environ.get("PHOTON_REJOIN_BOOT"):
        with open(os.path.join(work, f"rejoiner-{rank}.pid"), "w") as fh:
            fh.write(str(os.getpid()))
        mh.bootstrap_rejoin()
    else:
        mh.initialize_multihost(f"127.0.0.1:{port}", nproc, rank)
    if mode.get("telemetry_dir"):
        obs.configure(mode["telemetry_dir"], run_id=mode["run_id"])
    t, model = drill.streamed_fit(rank, nproc, mode)
    obs.shutdown()
    sub = model.models["per_entity"]
    np.savez(os.path.join(work, f"streamed-{rank}.npz"), W=sub.coefficients.cpu().numpy(),
             V=sub.variances.cpu().numpy())
    with open(os.path.join(work, f"streamed-{rank}.json"), "w") as fh:
        json.dump({"counters": drill._counters(), "boot": bool(os.environ.get("PHOTON_REJOIN_BOOT")),
                   "resumed_from": list(t.resumed_from) if t.resumed_from is not None else None}, fh)
    sys.stdout.flush()
    os._exit(0)


def run_rejoin_workers(work, mode: dict, env: dict, rejoiner: int | None = None) -> dict:
    """``NPROC`` workers in one process group on a fresh port, each with
    ``PHOTON_REJOIN_CMD`` its own argv. The worker ``rejoiner`` must exit
    137 (the ``rejoin`` op) and its re-exec'd process, which holds the same
    pipes, must leave its results; every other worker exits 0. Everything,
    the rejoiner included, is killed after ``WORKER_TIMEOUT_S``. Returns
    each rank's (arrays, meta)."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("PHOTON_") and k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                                                          "JAX_PROCESS_ID")}
    base.update(OMP_NUM_THREADS="1", **env)
    port = str(drill._free_port())
    procs = []
    for r in range(NPROC):
        argv = [sys.executable, "-c", _WORKER, ROOT, port, str(r), str(NPROC), str(work), json.dumps(mode)]
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                      env=dict(base, PHOTON_REJOIN_CMD=json.dumps(argv))))
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
        pid_file = os.path.join(work, f"rejoiner-{rejoiner}.pid")
        if rejoiner is not None and os.path.exists(pid_file):
            try:
                os.kill(int(open(pid_file).read()), signal.SIGKILL)
            except ProcessLookupError:  # it finished
                pass
    done = {}
    for rank, (rc, out, err) in enumerate(results):
        want = 137 if rank == rejoiner else 0
        assert rc == want, f"worker {rank} exited {rc}, expected {want}:\n{out}\n{err[-6000:]}"
        path = os.path.join(work, f"streamed-{rank}")
        assert os.path.exists(path + ".json"), f"worker {rank} left no result:\n{out}\n{err[-6000:]}"
        with open(path + ".json") as fh:
            meta = json.load(fh)
        done[rank] = (dict(np.load(path + ".npz")), meta)
    return done


def check_rejoin(tmp_path, plan: list[dict], clean: dict, device: str = "cpu", telemetry: bool = False) -> None:
    """The rejoin drill on ``device``: every process's model bitwise the
    uninterrupted run ``clean`` (``run_rejoin_workers``' result), the
    survivors' recovery and rejoin counted once, the rejoiner re-exec'd
    and its rejoin counted once; with ``telemetry``, the fleet's
    ``recovery`` and ``rejoin`` records as the reference's drill reads
    them."""
    from photon_ml_tpu_torch.obs.report import fleet_run_paths, load_run

    (tmp_path / "chaos").mkdir(parents=True)
    teldir = tmp_path / "tel"
    mode = {"iterations": 3, "checkpoint_dir": str(tmp_path / "ckpt"), "device": device}
    if telemetry:
        mode.update(telemetry_dir=str(teldir), run_id="RJ1")
    env = dict(REJOIN_ENV, PHOTON_REJOIN="1", PHOTON_REJOIN_WINDOW_S="25",
               PHOTON_MESH_CACHE=str(tmp_path / "mesh.json"), PHOTON_FAULT_PLAN=json.dumps(plan))
    res = run_rejoin_workers(tmp_path / "chaos", mode, env, rejoiner=3)
    assert res[3][1]["boot"] and not any(res[p][1]["boot"] for p in range(3))
    for p in range(3):
        counters = res[p][1]["counters"]
        for name in ("fleet.peer_lost", "fleet.recoveries", "fleet.rejoins"):
            assert counters.get(name) == 1.0, (p, counters)
    assert res[3][1]["counters"].get("fleet.rejoins") == 1.0, res[3][1]["counters"]
    assert "fleet.peer_lost" not in res[3][1]["counters"]
    for p in range(NPROC):
        for k in ("W", "V"):
            assert res[p][0][k].tobytes() == clean[p][0][k].tobytes(), (p, k)
    if not telemetry:
        return
    records = [(i, r) for i, path in enumerate(fleet_run_paths(str(teldir), run_id="RJ1")) for r in load_run(path)]
    recoveries = [r for _, r in records if r["event"] == "recovery"]
    assert len(recoveries) == 3
    assert all(r["lost"] == [3] and r["survivors"] == [0, 1, 2] for r in recoveries)
    rejoins = [r for _, r in records if r["event"] == "rejoin"]
    assert len(rejoins) == NPROC
    assert {r["role"] for r in rejoins} == {"survivor", "rejoiner"}
    assert all(r["rejoined"] == [3] for r in rejoins)
    assert all(r["group"] == [0, 1, 2, 3] for r in rejoins)
    assert all(r["iteration"] == 1 and r["coordinate_index"] == 0 for r in rejoins if r["role"] == "survivor")
    assert sum(r["event"] == "rejoin_invited" for _, r in records) == 1


def clean_run(tmp_path, device: str = "cpu") -> dict:
    """The uninterrupted four-process fit the drills are held to."""
    (tmp_path / "clean").mkdir(parents=True)
    return run_rejoin_workers(tmp_path / "clean", {"iterations": 3, "checkpoint_dir": str(tmp_path / "ckpt-clean"),
                                                   "device": device}, REJOIN_ENV)


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return clean_run(tmp_path_factory.mktemp("clean"))


def test_rejoin_after_kill_bitwise_with_four_processes(tmp_path, clean):
    check_rejoin(tmp_path, KILL_AND_REJOIN, clean, telemetry=True)


def test_rejoin_races_degrade_roll_call(tmp_path, clean):
    check_rejoin(tmp_path, RACE, clean)


def test_clean_run_is_the_same_model_on_every_process(clean):
    for p in range(1, NPROC):
        assert clean[p][0]["W"].tobytes() == clean[0][0]["W"].tobytes()
        assert not clean[p][1]["counters"]
