#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s wall goes: its main thread sampled every 0.1 s.

    python3 scripts/smoke_profile.py [--drivers] [--out PATH]

Runs the smoke's ``main`` (or, with ``--drivers``, only its drivers block,
phases 16-18e, after the kernel build) with a thread that reads the main
thread's stack ten times a second. Writes one JSON object to ``--out``
(default ``chiprun_out/smoke_profile.json``): the seconds of importing the
smoke module in this process, each step's seconds (``--drivers``), the
seconds each of the smoke's functions was on the stack, and the most
frequent (phase, deepest smoke function, outermost port function,
innermost frame) chains with their seconds. Time a child process spends
shows as its parent waiting in ``join_children``. Needs one CUDA card; run
it from the root of a checkout.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile
import threading
import time

ROOT = os.getcwd()
DT = 0.1


class Sampler:
    """Counts of the main thread's stacks, ``DT`` apart."""

    def __init__(self):
        self.ident = threading.get_ident()
        self.step = "?"
        self.inclusive = collections.Counter()
        self.chains = collections.Counter()
        self.stopped = False
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        while not self.stopped:
            time.sleep(DT)
            f = sys._current_frames().get(self.ident)
            stack = []
            while f is not None:
                stack.append(f)
                f = f.f_back
            stack.reverse()
            smoke = [fr.f_code.co_name for fr in stack if fr.f_code.co_filename.endswith("chip_smoke.py")]
            for name in set(smoke):
                self.inclusive[name] += 1
            phase = self.step if self.step != "?" else (smoke[1] if len(smoke) > 1 else "?")
            port = next((f"{os.path.relpath(fr.f_code.co_filename, ROOT)}:{fr.f_code.co_name}" for fr in stack
                         if "photon_ml_tpu_torch" in fr.f_code.co_filename), "")
            inner = stack[-1].f_code if stack else None
            where = f"{os.path.basename(inner.co_filename)}:{inner.co_name}" if inner else "?"
            self.chains[(phase, smoke[-1] if smoke else "?", port, where)] += 1

    def result(self) -> dict:
        self.stopped = True
        return dict(dt=DT, inclusive_s={k: round(v * DT, 1) for k, v in self.inclusive.most_common()},
                    chains=[dict(phase=k[0], deep=k[1], port=k[2], inner=k[3], s=round(v * DT, 1))
                            for k, v in self.chains.most_common(500)])


def drivers(cs, sampler: Sampler, steps: dict) -> None:
    """The smoke's drivers block as ``main`` runs it, each step timed."""
    import torch

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()

    def step(name, fn, *args):
        sampler.step = name
        t0 = time.perf_counter()
        out = fn(*args)
        steps[name] = time.perf_counter() - t0
        print(json.dumps({"step": name, "s": steps[name]}), flush=True)
        return out

    cs.start_forkserver()
    step("build", lambda: (cs.native_build.build(), cs._cuda.build()))
    work = tempfile.mkdtemp(prefix="_game_cli-", dir=ROOT)
    t0 = time.perf_counter()
    try:
        data = step("game_cli_data", cs.game_cli_data, dev, work)
        step("native_read_parity", cs.native_read_parity, data.work, data.effects)
        cli = step("run_game_cli", cs.run_game_cli, dev, data)
        step("run_game_cli_full", cs.run_game_cli_full, dev, data, os.path.join(work, "glm", "best", "model.avro"))
        glm_streamed = step("run_glm_streamed_cli", cs.run_glm_streamed_cli, dev, data, smi)
        step("run_glm_multihost_cli", cs.run_glm_multihost_cli, dev, data, glm_streamed, smi)
        step("run_game_multihost_cli", cs.run_game_multihost_cli, dev, data, cli, smi)
        step("run_game_cli_streamed", cs.run_game_cli_streamed, dev, data, smi)
        step("run_game_cli_streamed_multihost", cs.run_game_cli_streamed_multihost, dev, data, smi)
        step("run_telemetry", cs.run_telemetry, dev, data, cli, glm_streamed)
        step("run_tools", cs.run_tools, dev, data, smi)
    finally:
        steps["drivers_block"] = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drivers", action="store_true", help="only the drivers block (phases 16-18e)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "smoke_profile.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    import chip_smoke as cs

    steps = {"import_chip_smoke": time.perf_counter() - t0}
    sampler = Sampler()
    rc = 1
    try:
        if args.drivers:
            drivers(cs, sampler, steps)
            rc = 0
        else:
            rc = cs.main()
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(steps=steps, **sampler.result()), f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
