"""Racing misses of the stream executor's chunk-cache arbiter, counted in
both packages on the fixture of ``tests/test_torch_telemetry.py::
TestSinkAndSchema::test_stream_executor_names_equal_the_references[1]``.

Each package's ``ops/stream_executor.py`` copies a miss outside its lock:
two prefetch workers that miss on one content at once both count a miss,
and the one that inserts second is served the first one's entry (a racing
miss); had it come a moment later it would have counted a hit. So the
split of hits and misses moves with thread timing, and hits + racing
misses and misses − racing misses (the entries created) do not. This
script runs the fixture ``--runs`` times in each package (the prefetch
depth and budget of the test, the executor on) and prints, per run, the
arbiter's hits, misses, shared hits and evictions, the entries it
created (counted by wrapping its ``_Entry``) and the racing misses
(misses − entries created), then whether the invariants held.

    JAX_PLATFORMS=cpu python scripts/stream_cache_races.py --runs 40
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


def _fixture():
    rng = np.random.default_rng(3)  # tests/test_torch_telemetry.py _glm_arrays
    n, d = 300, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ rng.normal(size=d)))).astype(np.float32)
    return X, y


def _run(pkg: str, X, y, chunks, work: str) -> dict:
    """One run of the test's body in one package, under a sink."""
    if pkg == "port":
        import torch  # noqa: F401 - the port's tensors

        from photon_ml_tpu_torch import obs
        from photon_ml_tpu_torch.obs.report import load_run
        from photon_ml_tpu_torch.ops import prefetch as pf
        from photon_ml_tpu_torch.ops import stream_executor as se
        from photon_ml_tpu_torch.ops.losses import loss_for_task
        from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective as Objective
        from photon_ml_tpu_torch.ops.streaming import stream_scores as scores
        from photon_ml_tpu_torch.types import TaskType
        kw = {"device": "cpu"}
    else:
        from photon_ml_tpu import obs
        from photon_ml_tpu.obs.report import load_run
        from photon_ml_tpu.ops import prefetch as pf
        from photon_ml_tpu.ops import stream_executor as se
        from photon_ml_tpu.ops.losses import loss_for_task
        from photon_ml_tpu.ops.streaming import StreamingGLMObjective as Objective
        from photon_ml_tpu.ops.streaming import stream_scores as scores
        from photon_ml_tpu.types import TaskType
        kw = {}
    created = [0]
    entry = se._Entry

    class Counted(entry):
        __slots__ = ()

        def __init__(self, *a, **k):
            created[0] += 1
            super().__init__(*a, **k)

    copies = [{k: np.array(v) for k, v in c.items()} for c in chunks]
    w = np.full(X.shape[1], 0.1, np.float32)
    pf.clear_cache()
    se.clear()
    obs.REGISTRY.reset(prefix="stream")
    se._Entry = Counted
    path = obs.configure(work)
    try:
        obj = Objective(chunks, loss_for_task(TaskType.LOGISTIC_REGRESSION), X.shape[1], **kw)
        obj.value(w)
        obj.value(w)
        scores(copies, w, len(y), **kw)
        with se.active_stream("serve"):
            list(se.stream("refresh", 6, lambda i: i))
    finally:
        obs.shutdown()
        se._Entry = entry
    cache = load_run(path)[-1]["stream_cache"]
    return dict(hits=cache["hits"], misses=cache["misses"], shared_hits=cache["shared_hits"],
                evictions=cache["evictions"], created=created[0], racing=cache["misses"] - created[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=40)
    args = ap.parse_args()
    os.environ.update(PHOTON_STREAM_EXECUTOR="1", PHOTON_PREFETCH_DEPTH="2", PHOTON_CHUNK_CACHE_BUDGET=str(1 << 20),
                      PHOTON_DEVCOST="0")
    from photon_ml_tpu_torch.ops.streaming import dense_chunks

    X, y = _fixture()
    chunks = dense_chunks(X, y, 64)
    rows = {"port": [], "reference": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            for pkg in rows:
                rows[pkg].append(_run(pkg, X, y, chunks, os.path.join(tmp, f"{pkg}{i}")))
    for pkg, rs in rows.items():
        for r in rs:
            print(json.dumps(dict(package=pkg, **r)))
    inv = {pkg: sorted({(r["hits"] + r["racing"], r["misses"] - r["racing"], r["shared_hits"], r["evictions"])
                        for r in rs}) for pkg, rs in rows.items()}
    print(json.dumps(dict(
        runs=args.runs,
        hits_seen={pkg: sorted({r["hits"] for r in rs}) for pkg, rs in rows.items()},
        racing_seen={pkg: sorted({r["racing"] for r in rs}) for pkg, rs in rows.items()},
        invariants_seen={pkg: [list(t) for t in v] for pkg, v in inv.items()},
        invariant_in_each_package=all(len(v) == 1 for v in inv.values()),
        invariant_equal_across_packages=inv["port"] == inv["reference"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
