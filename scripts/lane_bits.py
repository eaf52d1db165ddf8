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

Then the lane products and reductions alone, at the lane counts lane
compaction and fusion give (``OP_SHAPES``, up to 1024 lanes): for each
op, every sub-batch (the first m lanes, and m gathered lanes, m = k/2
down to 2) whose rows differ from the whole batch's, with the largest
difference. ``bmm_*`` are ``DenseBatch.matvec`` / ``rmatvec``'s batched
products, ``sum_rows`` a row sum over C (the objective's), ``norm_d`` a
lane norm; ``mulsum_*`` the same products as a product and a sum.
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
OP_SHAPES = ((1024, 32, 8), (256, 256, 8), (64, 2048, 8), (16, 16384, 8), (512, 64, 32), (40, 1024, 9))
OPS = {
    "bmm_matvec": lambda X, w, r: torch.bmm(X, w.unsqueeze(-1)).squeeze(-1),
    "bmm_rmatvec": lambda X, w, r: torch.bmm(X.transpose(1, 2), r.unsqueeze(-1)).squeeze(-1),
    "mulsum_matvec": lambda X, w, r: (X * w.unsqueeze(1)).sum(-1),
    "mulsum_rmatvec": lambda X, w, r: (X * r.unsqueeze(-1)).sum(1),
    "sum_rows": lambda X, w, r: torch.sum(r * r, dim=-1),
    "norm_d": lambda X, w, r: torch.linalg.norm(w, dim=-1),
    "sigmoid": lambda X, w, r: torch.sigmoid(r),
}


def op_bits(dev: torch.device) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    for k, C, d in OP_SHAPES:
        X = torch.randn((k, C, d), generator=g, device=dev)
        w = torch.randn((k, d), generator=g, device=dev)
        r = torch.randn((k, C), generator=g, device=dev)
        res = {}
        for name, fn in OPS.items():
            full, bad, m = fn(X, w, r), [], k // 2
            while m >= 2:
                for kind, sel in (("head", torch.arange(m, device=dev)),
                                  ("gather", torch.randperm(k, generator=g, device=dev)[:m])):
                    sub = fn(X[sel].contiguous(), w[sel].contiguous(), r[sel].contiguous())
                    if not torch.equal(sub, full[sel]):
                        bad.append(f"{kind}{m}:{float((sub - full[sel]).abs().max()):.2e}")
                m //= 2
            res[name] = bad
        print("ops", (k, C, d), res, flush=True)


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
    op_bits(dev)


if __name__ == "__main__":
    main()
