"""The online serving driver, ``photon-ml-tpu-torch serve`` (port of
``photon_ml_tpu/cli/serve.py``).

Loads a published GAME model (a root that ``io/model_io.
publish_game_model`` wrote, with its ``MANIFEST.json``) or a bare
``save_game_model`` directory into a ``HotModelStore`` on ``--device``
(CUDA by default; the driver never moves to the CPU on its own), and drives
the micro-window scoring loop with an open-loop Zipf trace at a fixed
offered rate, with the latency and hit-rate telemetry of a
``--telemetry-dir`` run for ``photon-ml-tpu-torch report``.

Hot swap: with ``--poll-every N`` the trace runs in slices of N requests,
and between slices the manifest's fingerprint is read again
(``peek_published_fingerprint``: no model is loaded). A new fingerprint
loads the new snapshot into a fresh store before the next slice. The
publish is atomic, so a poll sees the old snapshot or the new one whole.

Standard output is one JSON line: requests, windows, p50 / p99 latency,
hot-set hit rate, occupancy, swaps.

Usage:
    photon-ml-tpu-torch serve --model-root published/ \\
        [--requests 10000] [--rate-hz 2000] [--zipf-s 1.0] [--seed 0] \\
        [--hot-bytes N] [--max-batch B] [--max-wait-ms W] \\
        [--poll-every N] [--telemetry-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from photon_ml_tpu_torch.utils import PhotonLogger


def _synthetic_requests(model, n: int, zipf_s: float, seed: int) -> list:
    """An open-loop request list shaped by the model: one Zipf entity
    stream per random-effect tag and N(0, 1) features per shard at the
    model's widths (the caller stamps the arrivals). The same requests as
    the reference driver's for the same model and seed."""
    from photon_ml_tpu_torch.game.models import FixedEffectModel, RandomEffectModel
    from photon_ml_tpu_torch.serve.loadgen import zipf_entity_trace
    from photon_ml_tpu_torch.serve.router import ScoreRequest

    rng = np.random.default_rng(seed)
    shard_dims: dict[str, int] = {}
    id_streams: dict[str, np.ndarray] = {}
    for i, (cid, sub) in enumerate(sorted(model.models.items())):
        if isinstance(sub, FixedEffectModel):
            shard_dims[sub.feature_shard_id] = int(sub.model.coefficients.dim)
        elif isinstance(sub, RandomEffectModel):
            shard_dims[sub.feature_shard_id] = int(sub.coefficients.shape[1])
            id_streams[sub.random_effect_type] = zipf_entity_trace(
                sub.num_entities, n, s=zipf_s, rng=np.random.default_rng(seed + 1 + i))
    features = {sid: rng.normal(size=(n, d)).astype(np.float32) for sid, d in shard_dims.items()}
    return [
        ScoreRequest(rid=i, features={sid: features[sid][i] for sid in shard_dims},
                     id_tags={tag: int(ids[i]) for tag, ids in id_streams.items()})
        for i in range(n)
    ]


def _load(model_root: str, device=None):
    """(model, fingerprint or None): the manifest's snapshot when the root
    is published, else the bare ``save_game_model`` directory."""
    from photon_ml_tpu_torch.io.model_io import MODEL_MANIFEST, load_game_model, load_published_model

    if os.path.exists(os.path.join(model_root, MODEL_MANIFEST)):
        model, manifest = load_published_model(model_root, device=device)
        return model, manifest.get("fingerprint")
    return load_game_model(model_root, device=device), None


def run(model_root: str, requests: int = 10_000, rate_hz: float = 2000.0, zipf_s: float = 1.0, seed: int = 0,
        hot_bytes: int | None = None, max_batch: int | None = None, max_wait_ms: float | None = None,
        poll_every: int = 0, logger: PhotonLogger | None = None, device=None) -> dict:
    """Serve one open-loop trace from ``model_root`` on ``device`` (CUDA
    unless the caller asks for another); prints and returns the summary.
    The returned dict also holds ``scores`` (request id → score),
    ``swap_at`` (the request index each hot swap took effect at) and
    ``total_re_bytes``, which the printed line leaves out."""
    from photon_ml_tpu_torch._device import resolve_device
    from photon_ml_tpu_torch.io.model_io import peek_published_fingerprint
    from photon_ml_tpu_torch.serve.loadgen import open_loop_arrivals, run_serve_trace
    from photon_ml_tpu_torch.serve.store import HotModelStore

    dev = resolve_device(device)
    logger = logger or PhotonLogger(None)
    model, fingerprint = _load(model_root, dev)
    store = HotModelStore(model, budget_bytes=hot_bytes, device=dev)
    logger.info(f"serving model from {model_root} (fingerprint {fingerprint or 'unpublished'}) on {dev}: "
                f"hot budget {store.budget_bytes()}B of {store.total_re_bytes}B RE bytes")

    reqs = _synthetic_requests(model, requests, zipf_s, seed)
    arrivals = open_loop_arrivals(requests, rate_hz, rng=np.random.default_rng(seed + 97))
    for r, t in zip(reqs, arrivals):
        r.arrival_s = float(t)

    swaps = 0
    slices = [reqs] if poll_every <= 0 else [reqs[i:i + poll_every] for i in range(0, len(reqs), poll_every)]
    lat_p50 = lat_p99 = occupancy = elapsed = 0.0
    windows = 0
    base_s = 0.0
    latencies: list[float] = []
    scores: dict[int, float] = {}
    swap_at: list[int] = []
    served = 0
    for sl in slices:
        # each slice's arrivals start at its own zero, so a long manifest
        # poll or a slow slice bills no queueing delay to the next one
        for r in sl:
            r.arrival_s -= base_s
        base_s += float(sl[-1].arrival_s)
        summary = run_serve_trace(store, sl, max_batch=max_batch, max_wait_ms=max_wait_ms)
        windows += summary["windows"]
        lat_p50, lat_p99 = summary["latency_p50_ms"], summary["latency_p99_ms"]
        occupancy = summary["window_occupancy_mean"]
        elapsed += summary["elapsed_s"]
        latencies.append(summary["latency_mean_ms"] * len(sl))
        scores.update(summary["scores"])
        served += len(sl)
        if poll_every > 0 and fingerprint is not None:
            fresh = peek_published_fingerprint(model_root)
            if fresh is not None and fresh != fingerprint:
                model, fingerprint = _load(model_root, dev)
                store = HotModelStore(model, budget_bytes=hot_bytes, device=dev)
                swaps += 1
                swap_at.append(served)
                logger.info(f"hot-swapped snapshot (fingerprint {fresh})")

    out = {
        "requests": requests,
        "windows": windows,
        "latency_p50_ms": round(lat_p50, 4),
        "latency_p99_ms": round(lat_p99, 4),
        "hot_hit_rate": round(store.hit_rate(), 4),
        "window_occupancy_mean": round(occupancy, 4),
        "hot_budget_bytes": store.budget_bytes(),
        "snapshot_swaps": swaps,
        "fingerprint": fingerprint,
        "latency_mean_ms": round(sum(latencies) / max(requests, 1), 4),
        "elapsed_s": round(elapsed, 4),
        "device": str(dev),
    }
    print(json.dumps(out))
    return dict(out, total_re_bytes=store.total_re_bytes, scores=scores, swap_at=swap_at)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="online GAME serving driver")
    p.add_argument("--model-root", required=True, help="published-model root (MANIFEST.json) or a bare model dir")
    p.add_argument("--requests", type=int, default=10_000)
    p.add_argument("--rate-hz", type=float, default=2000.0)
    p.add_argument("--zipf-s", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hot-bytes", type=int, default=None,
                   help="hot-set byte budget (default: PHOTON_SERVE_HOT_BYTES, else 25%% of the model's "
                        "random-effect bytes)")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--max-wait-ms", type=float, default=None)
    p.add_argument("--poll-every", type=int, default=0,
                   help="read the manifest's fingerprint again every N requests and hot-swap a newly "
                        "published snapshot in (0 = never)")
    p.add_argument("--telemetry-dir", default=None,
                   help="write the run's telemetry JSONL into this directory; read it with "
                        "`photon-ml-tpu-torch report`")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from photon_ml_tpu_torch import obs

    obs.configure(args.telemetry_dir, run_id="serve")
    try:
        run(args.model_root, requests=args.requests, rate_hz=args.rate_hz, zipf_s=args.zipf_s, seed=args.seed,
            hot_bytes=args.hot_bytes, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            poll_every=args.poll_every, device=args.device)
    finally:
        obs.shutdown()


if __name__ == "__main__":
    main()
