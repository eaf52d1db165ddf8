#!/usr/bin/env python3
"""K1 alone at GAME's widths, for two checkouts of the repository in turns.

    python3 scripts/k1_turns.py PARENT_DIR CHANGE_DIR

Runs each checkout's ``chip_smoke.k1_at`` in its own process, from its own
directory (so each builds and loads its own kernels), in the order parent,
change, change, parent: at config E's fixed-effect shape at MovieLens-20M
depth (20,000,263 x 65, float32, logistic, offsets read) and at config D's
(2^18 x 65, offsets not read), on the same data from the same seed. Prints
the card's name and power limit, then one JSON line per run. Needs one CUDA
card; compare the two checkouts only within one run.
"""

from __future__ import annotations

import json
import subprocess
import sys

RUN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
from photon_ml_tpu_torch.ops import _cuda
_cuda.build()
dev = torch.device("cuda")
out = {}
for name, n, with_offsets in (("e", 20_000_263, True), ("d", 1 << 18, False)):
    g = torch.Generator(device=dev).manual_seed(5)
    X = torch.randn((n, 65), generator=g, device=dev)
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    off = 0.1 * torch.randn(n, generator=g, device=dev) if with_offsets else None
    out[name] = chip_smoke.k1_at(X, off, y, dev)
    del X, y, off
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    parent, change = argv
    for tree, label in ((parent, "parent"), (change, "change"), (change, "change"),
                        (parent, "parent")):
        run = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(json.dumps({"tree": label, **json.loads(run.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
