"""What the card's torch offers for captured CUDA graphs whose loops the
device decides, and whether ``ops/graphs.py`` works there.

Prints one JSON line a check: the card; whether torch has the
conditional-node API (``CUDAGraph.begin_capture_to_if_node``) and the
pieces ``ops/graphs.py`` uses instead (``CUDAGraph(keep_graph=True)``,
``raw_cuda_graph``, ``capture_begin(pool=)``); a nested device loop
(``graphs.loop`` inside ``graphs.loop``) against its eager run; a loop
body of the lane solvers' operations (batched ``cholesky_ex``,
``solve_triangular``, ``bmm``, ``index_put_``) replayed against the eager
loop, bitwise; what a host read inside a capture raises; and the
microseconds a replay of a loop that runs no trip costs.

    python3 scripts/graph_probe.py          # on a machine with a card
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from photon_ml_tpu_torch.ops import graphs  # noqa: E402


def out(**kw) -> None:
    print(json.dumps(kw), flush=True)


def warm_and_capture(fn, dev, stream):
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, _ = graphs.capture(fn, dev, stream)
    return g, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    stream = torch.cuda.Stream(dev)
    def has(fn) -> bool | str:
        try:
            fn()
            return True
        except Exception as e:  # noqa: BLE001 - the probe reports what is missing
            return f"{type(e).__name__}: {e}"[:160]

    out(check="api", torch=torch.__version__, cuda=torch.version.cuda, card=smi,
        if_node=hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node"),
        keep_graph=has(lambda: torch.cuda.CUDAGraph(keep_graph=True)),
        raw_cuda_graph=hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"),
        graph_pool_handle=hasattr(torch.cuda, "graph_pool_handle"))

    # nested loops: x doubles while below a limit (at most 10 trips); in
    # each trip y counts down by one while above x's trip count (at most 3)
    x = torch.ones((), device=dev)
    y = torch.zeros((), device=dev)
    inner_n = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    limit = torch.full((), 20.0, device=dev)

    def nested():
        flag.copy_(x < limit)

        def body(_trip):
            x.mul_(2.0)
            y.add_(5.0)
            inner = y > 2.0

            def count_down(_trip):
                y.sub_(1.0)
                inner_n.add_(1)
                inner.copy_(y > 2.0)

            graphs.loop(3, inner, count_down)
            flag.copy_(x < limit)

        graphs.loop(10, flag, body)

    results = {}
    for mode in ("eager", "graph"):
        x.fill_(1.0), y.fill_(0.0), inner_n.zero_()
        if mode == "eager":
            nested()
        else:
            try:
                g, s = warm_and_capture(nested, dev, stream)
            except RuntimeError as e:
                out(check="nested_loops", error=str(e)[:400])
                return 1
            x.fill_(1.0), y.fill_(0.0), inner_n.zero_()
            g.replay()
        torch.cuda.synchronize()
        results[mode] = [float(x), float(y), int(inner_n)]
    out(check="nested_loops", results=results, equal=results["eager"] == results["graph"],
        capture_s=s, nodes=g.nodes)

    # the lane solvers' operations in a loop body
    k, d = 256, 9
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(k, 40, d, device=dev, generator=gen)
    W = torch.zeros(1000, d, device=dev)
    ids = torch.randperm(1000, device=dev, generator=gen)[:k]
    w = torch.zeros(k, d, device=dev)
    g0 = torch.randn(k, d, device=dev, generator=gen)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)

    def solve():
        go.fill_(True)

        def body(_trip):
            H = torch.bmm(A.transpose(1, 2), A) + 1e-3 * torch.eye(d, device=dev)
            L, info = torch.linalg.cholesky_ex(H)
            z = torch.linalg.solve_triangular(L, (g0 - w).unsqueeze(-1), upper=False)
            p = torch.linalg.solve_triangular(L.transpose(-2, -1), z, upper=True).squeeze(-1)
            w.copy_(torch.where((info == 0).unsqueeze(-1), w + 0.5 * p, w))
            W.index_put_((ids,), w)
            it.add_(1)
            go.copy_(torch.linalg.norm(p, dim=-1).max() > 1e-3)

        graphs.loop(25, go, body)

    snaps = {}
    for mode in ("eager", "graph"):
        w.zero_(), W.zero_(), it.zero_()
        if mode == "eager":
            solve()
        else:
            try:
                g, s = warm_and_capture(solve, dev, stream)
            except RuntimeError as e:
                out(check="lane_ops", error=str(e)[:400])
                return 1
            w.zero_(), W.zero_(), it.zero_()
            g.replay()
        torch.cuda.synchronize()
        snaps[mode] = (W.clone(), int(it))
    out(check="lane_ops", bitwise=bool(torch.equal(snaps["eager"][0], snaps["graph"][0])),
        trips=[snaps["eager"][1], snaps["graph"][1]], capture_s=s, nodes=g.nodes)

    def host_read():
        bool(A.sum() > 0)

    try:
        warm_and_capture(host_read, dev, stream)
        out(check="host_read_in_capture", raised=False)
    except RuntimeError as e:
        out(check="host_read_in_capture", raised=True, error=str(e)[:200])

    # a loop that runs no trip, replayed: what the condition nodes cost
    stop = torch.zeros((), dtype=torch.bool, device=dev)

    def idle():
        for _ in range(100):
            graphs.loop(10, stop, lambda _trip: x.add_(1.0))

    g, _ = warm_and_capture(idle, dev, stream)
    g.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        g.replay()
    torch.cuda.synchronize()
    out(check="idle_loop_us", us_per_loop=(time.perf_counter() - t0) / 20 / 100 * 1e6, card=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
