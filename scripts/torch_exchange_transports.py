#!/usr/bin/env python3
"""``exchange_rows``' two transports of a healthy group, timed against each
other in two processes of this host (gloo over loopback, the port's
``photon_ml_tpu_torch.parallel.multihost``).

    python3 scripts/torch_exchange_transports.py [--reps 7]

For each size (process 0's rows) and shape it builds one exchange: rows of an int64
id, a float32 label and 8 float32 features (44 bytes a row), sent
``balanced`` (every (source, destination) block a quarter of the rows) or
``skewed`` (process 1 holds a quarter as many rows as process 0 and
sends them all to process 0, which keeps 90% of its own: one block holds
most of the payload, and the reference's rule, P²·max > 2·payload,
picks the framed mesh). Each rep runs the exact-size gloo all_to_all (``_exchange_on``) and the framed mesh
(``_host_p2p_exchange``) on the same rows, in alternating order, each
after a barrier; the first rep warms both (the mesh's first build) and is
left out. It checks that both deliver the same bytes and prints one JSON
line a cell: each rep's wall (the slower process's), the median of each,
and which transport the rule picks. The card's name and power limit
(``nvidia-smi``) come first where there is one: the exchange itself runs
on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1 << 12, 1 << 17)
SHAPES = ("balanced", "skewed")


def _rows(n: int, rank: int, shape: str):
    rng = np.random.default_rng(rank)
    if shape == "skewed" and rank == 1:
        n //= 4
    arrays = {"gid": np.arange(n, dtype=np.int64) + rank * n, "y": rng.uniform(size=n).astype(np.float32),
              "x": rng.normal(size=(n, 8)).astype(np.float32)}
    if shape == "balanced":
        dest = np.arange(n, dtype=np.int64) % 2
    else:
        dest = np.zeros(n, np.int64)
        if rank == 0:
            dest[: n // 10] = 1
    return arrays, dest


def worker(rank: int, port: int, reps: int) -> None:
    sys.path.insert(0, ROOT)
    from photon_ml_tpu_torch.parallel import multihost as mh

    mh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout_s=120)
    out = []
    for n in SIZES:
        for shape in SHAPES:
            arrays, dest = _rows(n, rank, shape)
            order = np.argsort(dest, kind="stable")
            counts = np.bincount(dest, minlength=2).astype(np.int64)
            starts = np.concatenate([[0], np.cumsum(counts)])
            matrix = mh.allgather_host(counts).reshape(2, 2)
            rule = "p2p_host" if 4 * int(matrix.max()) > 2 * int(matrix.sum()) else "gloo"
            walls = {"gloo": [], "p2p_host": []}
            got = {}
            for rep in range(reps + 1):
                for transport in (("gloo", "p2p_host") if rep % 2 else ("p2p_host", "gloo")):
                    mh.sync_processes(f"transports-{n}-{shape}-{rep}-{transport}")
                    t0 = time.perf_counter()
                    if transport == "gloo":
                        rows, _, _ = mh._exchange_on(arrays, order, counts, matrix, "transports")
                    else:
                        rows = mh._host_p2p_exchange(arrays, order, starts, matrix, tag="transports", stats={})
                    dt = time.perf_counter() - t0
                    if rep:
                        walls[transport].append(dt)
                    got[transport] = rows
            same = all(got["gloo"][k].tobytes() == got["p2p_host"][k].tobytes() for k in arrays)
            # the slower process's wall, rep by rep
            both = mh.allgather_host(np.asarray(walls["gloo"] + walls["p2p_host"], np.float64)).reshape(2, -1)
            slow = both.max(axis=0)
            cell = dict(shape=shape, rows=[n, n // 4 if shape == "skewed" else n],
                        payload_bytes=int(matrix.sum()) * 44, counts=matrix.tolist(), rule_picks=rule, same_bytes=bool(same),
                        gloo_s=slow[:reps].tolist(), p2p_host_s=slow[reps:].tolist(),
                        gloo_median_s=float(np.median(slow[:reps])),
                        p2p_host_median_s=float(np.median(slow[reps:])))
            out.append(cell)
    if rank == 0:
        for cell in out:
            print(json.dumps(cell), flush=True)
    mh.sync_processes("transports-end")
    sys.stdout.flush()
    os._exit(0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.port, args.reps)
        return 0
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        print(smi)
    except (OSError, subprocess.SubprocessError):
        pass
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_")}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r), "--port", str(port),
                               "--reps", str(args.reps)], env=env) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return 0 if rcs == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
