#!/usr/bin/env python3
"""The random-effect lane solves of one source tree, saved, or two saved
runs compared bit for bit: the knob-off contract across commits.

    python3 scripts/lane_solve_bits.py TREE OUT.pt     # solve with TREE's photon_ml_tpu_torch
    python3 scripts/lane_solve_bits.py --compare A.pt B.pt

With every random-effect knob unset, ``train_random_effects`` solves
bench.py's R_re_skew (1024 entities of 32 rows, d = 8, one in 16
ill-conditioned; 200 iterations at 1e-7) and a Zipf bucket ladder (4,000
entities, 2^17 rows, d = 8) on L-BFGS, OWL-QN (L1 0.05), TRON and Newton
(20 iterations), SIMPLE variances, on CUDA (``--device`` to change), and
saves each solve's coefficients, variances, iterations and lane launches.
``--compare`` prints, per solve, whether every array is bitwise equal and
the launches the same, then the card's name and power limit, and exits 1
on any difference. Run the two trees in one call, in turns.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np


def problems() -> dict:
    out = {}
    rng = np.random.default_rng(7)
    E, C, d = 1024, 32, 8
    ids = np.repeat(np.arange(E), C)
    X = rng.normal(size=(E * C, d)).astype(np.float32)
    X[np.isin(ids, np.arange(0, E, 16))] *= np.geomspace(1.0, 60.0, d).astype(np.float32)
    W = (rng.normal(size=(E, d)) * 0.5).astype(np.float32)
    y = (rng.uniform(size=E * C) < 1 / (1 + np.exp(-np.clip(np.sum(W[ids] * X, 1), -60, 60)))).astype(np.float32)
    out["re_skew"] = (ids, X, y, E)
    E, n = 4000, 1 << 17
    p = 1.0 / (1.0 + np.arange(E)) ** 1.1
    ids = np.random.default_rng(8).choice(E, size=n, p=p / p.sum())
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    out["zipf"] = (ids, X, y, E)
    return out


def solve_tree(tree: str, out: str, device: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.game import DenseFeatures, bucket_entities, group_by_entity, train_random_effects
    from photon_ml_tpu_torch.game import random_effect as tre
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType

    for k in [k for k in os.environ if k.startswith("PHOTON_RE_")]:
        del os.environ[k]
    saved = {"tree": os.path.abspath(tree), "device": device}
    for name, (ids, X, y, E) in problems().items():
        feats = DenseFeatures(X=torch.from_numpy(X).to(device))
        buckets = bucket_entities(group_by_entity(ids, num_entities=E))
        for solver, l1, iters in (("LBFGS", 0.0, 200), ("LBFGS", 0.05, 200), ("TRON", 0.0, 200),
                                  ("NEWTON_CHOLESKY", 0.0, 20)):
            cfg = OptimizerConfig(optimizer_type=OptimizerType[solver], max_iterations=iters, tolerance=1e-7)
            tre.reset_launch_counts()
            res = train_random_effects(feats, y, np.zeros(len(y), np.float32), np.ones(len(y), np.float32), buckets,
                                       E, LOSSES["logistic"], cfg, l2_weight=1.0, l1_weight=l1,
                                       variance_computation=VarianceComputationType.SIMPLE, device=device)
            saved[f"{name}/{solver}/l1={l1}"] = dict(
                coefficients=res.coefficients.cpu(), variances=res.variances.cpu(),
                iterations=torch.as_tensor(res.iterations), launches=tre.launch_counts["launches"])
    torch.save(saved, out)
    print(f"saved {len(saved) - 2} solves of {saved['tree']} to {out}")


def compare(a: str, b: str) -> int:
    import torch

    A, B = torch.load(a), torch.load(b)
    same = True
    for key in A:
        if key in ("tree", "device"):
            continue
        x, y = A[key], B[key]
        bitwise = all(torch.equal(x[f], y[f]) for f in ("coefficients", "variances", "iterations"))
        launches = x["launches"] == y["launches"]
        diff = float((x["coefficients"] - y["coefficients"]).abs().max())
        print(f"{key}: bitwise {bitwise}, launches {x['launches']} / {y['launches']}, max |d| {diff:.3g}")
        same = same and bitwise and launches
    if A["device"].startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("paths", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.paths)
    solve_tree(*args.paths, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
