#!/usr/bin/env python3
"""Whether a random-effect lane's bits depend on the other lanes of its
bucket, on the device given (CUDA by default).

    python3 scripts/lane_bits.py [--device cuda|cpu]

One seeded bucket of k lanes (C rows each, the last quarter padding, d
features, logistic loss, L2 1, 8 iterations at tolerance 1e-9, SIMPLE
variances) is solved whole by ``solve_bucket_lanes``; then lane 0 again in
other compositions: alone, alone beside one all-padding lane (the streamed
trainer's lane floor), with lane 1, with two other lanes, and last of the
lanes in reverse order. For each (k, C, d) and solver (L-BFGS, Newton,
TRON) it prints whether lane 0's coefficients and variances equal the
whole bucket's bit for bit, and the largest coefficient difference. On
CUDA it prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from photon_ml_tpu_torch.config import OptimizerConfig  # noqa: E402
from photon_ml_tpu_torch.game.random_effect import solve_bucket_lanes  # noqa: E402
from photon_ml_tpu_torch.ops.batch import DenseBatch  # noqa: E402
from photon_ml_tpu_torch.ops.losses import loss_for_task  # noqa: E402
from photon_ml_tpu_torch.optim.common import select_minimize_fn  # noqa: E402
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType  # noqa: E402

SHAPES = ((7, 16, 3), (33, 64, 8), (5, 256, 9))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    for k, C, d in SHAPES:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(k, C, d)).astype(np.float32)
        y = (rng.uniform(size=(k, C)) < 0.5).astype(np.float32)
        w = np.ones((k, C), np.float32)
        w[:, (3 * C) // 4:] = 0
        X[:, (3 * C) // 4:] = 0
        off = (0.1 * rng.normal(size=(k, C))).astype(np.float32)
        for solver in ("LBFGS", "NEWTON_CHOLESKY", "TRON"):
            cfg = OptimizerConfig(optimizer_type=OptimizerType[solver], max_iterations=8, tolerance=1e-9)
            fn, extra = select_minimize_fn(cfg, 0.0)

            def solve(lanes, pad=False):
                arrays = [X[lanes], y[lanes], off[lanes], w[lanes]]
                if pad:
                    arrays = [np.concatenate([a, np.zeros_like(a[:1])]) for a in arrays]
                b = DenseBatch(*(torch.tensor(a, device=dev) for a in arrays))
                out = solve_bucket_lanes(b, torch.zeros(b.labels.shape[0], d, device=dev),
                                         torch.tensor(1.0, device=dev), None, None, None, minimize_fn=fn, loss=loss,
                                         config=cfg, intercept_index=None,
                                         variance_computation=VarianceComputationType.SIMPLE, **extra)
                return out[0].cpu().numpy(), out[4].cpu().numpy()

            whole = solve(list(range(k)))
            res = {}
            for name, lanes, pad in (("alone", [0], False), ("padded", [0], True), ("pair", [0, 1], False),
                                     ("subset", [0, 3, k - 1], False), ("moved", list(range(k - 1, -1, -1)), False)):
                got = solve(lanes, pad)
                pos = lanes.index(0)
                same = bool(np.array_equal(got[0][pos], whole[0][0]) and np.array_equal(got[1][pos], whole[1][0]))
                res[name] = (same, float(np.abs(got[0][pos] - whole[0][0]).max()))
            print((k, C, d), solver, res, flush=True)


if __name__ == "__main__":
    main()
