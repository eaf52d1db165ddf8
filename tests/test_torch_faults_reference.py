"""The port's peer-loss recoveries held against the reference's on the CPU:
the reference's own two-process chaos drills (``tests/test_multihost.py``
``_CHAOS_WORKER`` and ``_DESCENT_WORKER`` through ``_run_chaos_workers``)
and the port's (``tests/test_torch_faults_drill.py``) run on the same
fixture with the same fault plan, and the port's survivor's model is held
to the reference survivor's at the GAME multi-process tolerance, rtol 5e-3
/ atol 1e-3:

- the streamed peer kill: process 1 dies at link [1, 0], frame set 3, tag
  ``offsets`` (its second visit's offsets send); process 0 resumes from the
  last checkpoint over its own rows;
- the descent's degrade in place: a one-iteration anchor, then process 1
  dies at its first owner-segment combine send of the resumed descent;
  process 0's ``run`` returns. The reference's anchor is written by one
  process under the two-process fingerprint: its in-memory descent holds
  every row on every process, so the anchor is bitwise the two-process
  one (the reference's own contract), and its two-process clean run can
  lose its coordination service when process 0 exits first.

The writer's loss of three has no reference drill (a decided divergence,
ROADMAP queue 3) and is not here.

The reference's workers default ``PHOTON_COORD_MAX_MISSING_HEARTBEATS`` to
360 unless it is set, and its initialization hands that to a JAX
``State.initialize`` keyword that the installed JAX lacks; the knob is set
empty for them, which the reference reads as unset (JAX's own heartbeats,
far longer than these drills).
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_faults_drill as drill  # noqa: E402
from test_multihost import _DESCENT_WORKER, _run_chaos_workers  # noqa: E402

RTOL, ATOL = 5e-3, 1e-3


@pytest.fixture(autouse=True)
def _reference_worker_env(monkeypatch):
    for k in [k for k in os.environ if k.startswith("PHOTON_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PHOTON_COORD_MAX_MISSING_HEARTBEATS", "")


def _close(port: np.ndarray, ref, what: str) -> None:
    np.testing.assert_allclose(port, np.asarray(ref, np.float64), rtol=RTOL, atol=ATOL, err_msg=what)


def test_streamed_peer_kill_recovers_to_the_reference_s_model(tmp_path):
    (tmp_path / "port").mkdir()
    mode = {"iterations": 2, "checkpoint_dir": str(tmp_path / "ref-ckpt"), "fault_plan": drill.STREAMED_KILL}
    ref = _run_chaos_workers(2, {0: mode, 1: mode}, allow_kill=(1,))
    assert set(ref) == {0} and ref[0]["resumed_from"] == [1, 0]
    port = drill.run_workers("streamed", 2, tmp_path / "port",
                             {"iterations": 2, "checkpoint_dir": str(tmp_path / "port-ckpt"),
                              "fault_plan": drill.STREAMED_KILL},
                             env=dict(drill.FAULT_ENV, PHOTON_RE_SHARD="1"), allow_kill=(1,))
    arrays, meta = port[0]
    assert meta["resumed_from"] == [1, 0]
    for name in ("fleet.peer_lost", "fleet.recoveries", "p2p.giveups"):
        assert meta["counters"].get(name) == ref[0]["counters"].get(name) == 1.0, name
    _close(arrays["W"], ref[0]["W"], "W")
    _close(arrays["V"], ref[0]["V"], "V")


def test_descent_degrade_in_place_recovers_to_the_reference_s_model(tmp_path):
    anchor = {"iterations": 1, "checkpoint_dir": str(tmp_path / "ref-anchor"), "fingerprint": "descent-p2",
              "degrade": True}
    _run_chaos_workers(1, {0: anchor}, worker=_DESCENT_WORKER)
    shutil.copytree(tmp_path / "ref-anchor", tmp_path / "ref-chaos")
    chaos = dict(anchor, iterations=3, checkpoint_dir=str(tmp_path / "ref-chaos"), fault_plan=drill.DESCENT_KILL)
    ref = _run_chaos_workers(2, {0: chaos, 1: chaos}, allow_kill=(1,), worker=_DESCENT_WORKER)
    assert set(ref) == {0} and ref[0]["iterations_recorded"] == 2

    env = dict(drill.FAULT_ENV, PHOTON_RE_SHARD="1", PHOTON_RE_COMBINE="segments")
    (tmp_path / "port").mkdir()
    drill.run_workers("descent", 2, tmp_path / "port", dict(anchor, checkpoint_dir=str(tmp_path / "port-anchor")),
                      env=env)
    shutil.copytree(tmp_path / "port-anchor", tmp_path / "port-chaos")
    port = drill.run_workers("descent", 2, tmp_path / "port",
                             dict(chaos, checkpoint_dir=str(tmp_path / "port-chaos")), env=env, allow_kill=(1,))
    arrays, meta = port[0]
    assert meta["iterations_recorded"] == 2
    for name in ("fleet.peer_lost", "fleet.degraded_descents"):
        assert meta["counters"].get(name) == ref[0]["counters"].get(name) == 1.0, name
    _close(arrays["W"], ref[0]["W"], "W")
    _close(arrays["V"], ref[0]["V"], "V")
