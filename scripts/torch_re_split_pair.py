#!/usr/bin/env python3
"""``chip_smoke.py``'s main_e_multihost_re_split phase (config E at bench
depth, 2 processes on the card, one arm a child after another) from the
checkout at ``--root``, so that two commits can be timed on one card:

    python3 scripts/torch_re_split_pair.py --root <checkout> [--label name]

It builds that checkout's kernels, runs the phase through its own
``chip_smoke.run_e_multihost_re_split`` and prints one JSON line: the label,
the card's name and power limit, the phase's wall, and for the knob-off
(``off``) and owner-segment combine (``segments``) arms each process's wall
per outer iteration and per visit, the combine's seconds, exchange and
wait seconds and bytes sent, and whether the arm is bitwise its knob-off
twin. Run parent, change, change, parent in one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_re_split_pair: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    cs._cuda.build()
    build_s = time.perf_counter() - t0
    rec = cs.run_e_multihost_re_split(torch.device("cuda"), smi)
    keys = ("bitwise_vs_off", "timed_wall_s_per_outer_iteration", "timed_wall_s_per_visit", "combine_seconds",
            "combine_exchange_s", "combine_wait_s", "combine_bytes_sent", "combine_exchanges")
    print(json.dumps(dict(label=args.label or root, card=smi, build_s=build_s, phase_wall_s=rec["phase_wall_s"],
                          arms={arm: {k: rec["arms"][arm].get(k) for k in keys} for arm in ("off", "segments")})),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
