#!/usr/bin/env python3
"""K1's and K2's results of one checkout, for a bitwise comparison with
another checkout's.

    python3 scripts/fused_bits.py CHECKOUT OUT.pt     # run once per checkout
    python3 scripts/fused_bits.py --compare A.pt B.pt

The first form builds CHECKOUT's kernels and saves K1 (the layout its rule
picks) and K2 over the four losses, with and without offsets and weights,
at the headline shape, config B's, B's streamed chunk, a ragged d = 124
and GAME's width in both storage types, on inputs drawn on the card from
fixed seeds. Run each checkout in its own
process. The second form prints whether every saved tensor is equal, bit
for bit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

import torch

SHAPES = ((1 << 20, 512, torch.bfloat16), (1 << 20, 256, torch.float32), (1 << 17, 256, torch.float32),
          ((1 << 20) - 37, 124, torch.float32), (1 << 20, 65, torch.float32),
          ((1 << 20) - 37, 65, torch.bfloat16))


def save(checkout: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(checkout))
    from photon_ml_tpu_torch.ops import _cuda, fused
    from photon_ml_tpu_torch.ops.losses import LOSSES

    assert os.path.abspath(fused.__file__).startswith(os.path.abspath(checkout)), fused.__file__
    _cuda.build()
    dev = torch.device("cuda")
    res = {}
    for n, d, dtype in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + d)
        X = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        off = 0.1 * torch.randn(n, generator=gen, device=dev)
        wt = 0.5 + torch.rand(n, generator=gen, device=dev)
        u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
        v = torch.randn(d, generator=gen, device=dev) / d**0.5
        c, cv = torch.tensor(0.1, device=dev), torch.tensor(-0.05, device=dev)
        for name, loss in LOSSES.items():
            for o, w in ((None, None), (off, wt)):
                key = f"{n}x{d}:{dtype}:{name}:{o is not None}"
                res["k1:" + key] = [t.cpu() for t in fused.fused_value_grad(X, y, o, w, u, c, loss=loss)]
                k2 = fused.fused_hvp(X, y, o, w, u, v, c, cv, loss=loss)
                res["k2:" + key] = [t.cpu() for t in k2]
    torch.save(res, out)


def compare(a_path: str, b_path: str) -> dict:
    a, b = torch.load(a_path), torch.load(b_path)
    different = sorted(k for k in a.keys() | b.keys()
                       if k not in a or k not in b or not all(torch.equal(x, y) for x, y in zip(a[k], b[k])))
    return {"compared": len(a.keys() & b.keys()), "k1": sum(k.startswith("k1:") for k in a),
            "k2": sum(k.startswith("k2:") for k in a), "bitwise_equal": not different,
            "different": different[:10]}


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        print(json.dumps(compare(sys.argv[2], sys.argv[3])))
    else:
        save(sys.argv[1], sys.argv[2])
