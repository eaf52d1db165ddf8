"""``evaluation/host_sharded.py``: validation metrics over row-partitioned
host columns, against the JAX package's ``evaluate_host_sharded`` in one
process on the same seeded numpy inputs (loss metrics within 1e-6, the
histogram AUC within 1e-6 of the JAX value and 1e-4 of the exact AUC,
grouped partials equal), then over two gloo processes on the CPU (each
spawned with ``subprocess`` and killed after 120 s), whose combined
partials must give the one-process values: the histogram AUC bit for bit
(its bin masses are integers), the sums within rtol 1e-12; a process
with no rows takes part."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.evaluation import auc_roc, evaluate_host_sharded, grouped_auc_parts
from photon_ml_tpu_torch.evaluation import grouped_precision_at_k_parts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
N = 3000
LOSSES = ("RMSE", "LOGISTIC_LOSS", "POISSON_LOSS", "SQUARED_LOSS", "SMOOTHED_HINGE_LOSS")
AUCS = ("AUC", "BUCKETED_AUC(1024)")
GROUPED = ("MULTI_AUC(g)", "PRECISION_AT_K(3,g)")


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=N).astype(np.float32)
    labels = (rng.uniform(size=N) < 1 / (1 + np.exp(-2 * scores))).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    weights[::13] = 0.0  # rows of weight 0 count in no metric
    groups = rng.integers(0, 60, size=N).astype(np.int64)
    return dict(scores=scores, labels=labels, weights=weights, groups=groups)


def _grouped(x: dict, keep=slice(None)) -> dict:
    return {"g": (x["scores"][keep], x["labels"][keep], x["groups"][keep])}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.mark.parametrize("spec", LOSSES)
def test_loss_metrics_match_the_reference(inputs, spec):
    from photon_ml_tpu.evaluation.host_sharded import evaluate_host_sharded as jax_eval

    x = inputs
    got = evaluate_host_sharded([spec], x["scores"], x["labels"], x["weights"], {}).metrics[spec]
    want = jax_eval([spec], x["scores"], x["labels"], x["weights"], {}).metrics[spec]
    assert np.isfinite(got) and abs(got - want) <= 1e-6


@pytest.mark.parametrize("spec", AUCS)
def test_histogram_auc_matches_the_reference_and_the_exact_auc(inputs, spec):
    from photon_ml_tpu.evaluation.host_sharded import evaluate_host_sharded as jax_eval

    x = inputs
    got = evaluate_host_sharded([spec], x["scores"], x["labels"], x["weights"], {}).metrics[spec]
    want = jax_eval([spec], x["scores"], x["labels"], x["weights"], {}).metrics[spec]
    assert abs(got - want) <= 1e-6
    inc = x["weights"] > 0
    exact = float(auc_roc(torch.as_tensor(x["scores"][inc]), torch.as_tensor(x["labels"][inc])))
    assert abs(got - exact) <= (1e-4 if spec == "AUC" else 2e-3)


@pytest.mark.parametrize("spec", GROUPED)
def test_grouped_partials_match_the_reference(inputs, spec):
    from photon_ml_tpu.evaluation.evaluators import grouped_auc_parts as jax_auc_parts
    from photon_ml_tpu.evaluation.evaluators import grouped_precision_at_k_parts as jax_pk_parts
    from photon_ml_tpu.evaluation.host_sharded import evaluate_host_sharded as jax_eval

    x = inputs
    s, y, g = _grouped(x)["g"]
    if spec.startswith("MULTI_AUC"):
        got, want = grouped_auc_parts(s, y, g), jax_auc_parts(s, y, g)
    else:
        got, want = grouped_precision_at_k_parts(s, y, g, 3), jax_pk_parts(s, y, g, 3)
    assert got == want and got[1] > 0
    value = evaluate_host_sharded([spec], x["scores"], x["labels"], x["weights"], _grouped(x)).metrics[spec]
    assert value == jax_eval([spec], x["scores"], x["labels"], x["weights"], _grouped(x)).metrics[spec]
    assert value == got[0] / got[1]


def test_grouped_spec_without_owner_rows_raises(inputs):
    x = inputs
    with pytest.raises(KeyError, match="owner-routed"):
        evaluate_host_sharded(["MULTI_AUC(g)"], x["scores"], x["labels"], x["weights"], {})


_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, port, rank, work = sys.argv[1:5]
    rank = int(rank)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch
    torch.set_num_threads(1)
    import test_torch_host_sharded as t

    t.worker(rank, int(port), work)
    print("WORKER DONE", rank)
    """
)


def worker(rank: int, port: int, work: str) -> None:
    """One process: the metrics over its half of the rows (the groups
    split whole, by id parity), then with every row on process 0."""
    from photon_ml_tpu_torch.parallel import multihost as mh

    mh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout_s=100)
    x = _inputs()
    specs = LOSSES + AUCS + GROUPED
    out = {}
    for name, rows in (("halves", np.arange(N) % 2 == rank), ("empty", np.full(N, rank == 0))):
        mine = {k: v[rows] for k, v in x.items()}
        owned = x["groups"] % 2 == rank if name == "halves" else rows
        res = evaluate_host_sharded(specs, mine["scores"], mine["labels"], mine["weights"], _grouped(x, owned))
        out[name] = res.metrics
    mh.shutdown_multihost()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    work = tmp_path_factory.mktemp("host_sharded")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env["OMP_NUM_THREADS"] = "1"
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, port, str(r), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for r in range(2)]
    results = []
    try:
        for p in procs:
            results.append((p.returncode, *p.communicate(timeout=WORKER_TIMEOUT_S)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, ((_, out, err), p) in enumerate(zip(results, procs)):
        assert p.returncode == 0 and f"WORKER DONE {r}" in out, f"worker {r} failed:\n{out}\n{err[-4000:]}"
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("case", ["halves", "empty"])
def test_two_processes_combine_to_the_one_process_values(two_processes, inputs, case):
    x = inputs
    want = evaluate_host_sharded(LOSSES + AUCS + GROUPED, x["scores"], x["labels"], x["weights"],
                                 _grouped(x)).metrics
    got = [r[case] for r in two_processes]
    assert got[0] == got[1]  # the same bytes on both ranks
    assert list(got[0]) == list(want)
    for name, value in want.items():
        if name in AUCS:
            assert got[0][name] == value, name
        else:
            assert got[0][name] == pytest.approx(value, rel=1e-12), name
