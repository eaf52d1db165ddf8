#!/usr/bin/env python3
"""The drivers' wall with run telemetry on against off, in turns, on one card.

    python3 scripts/telemetry_overhead.py

On ``chip_smoke``'s GAME driver files (config E at bench.py's depth, 2^18
training rows, written once): the streamed GLM driver
(``main_glm_streamed_cli``'s command) and the in-memory GAME driver
(``main_game_cli``'s 2-iteration command), each in the order off, on, on,
off, where "on" adds ``--telemetry-dir`` alone; then the GAME driver once
more with ``--telemetry-dir`` and ``--profile-dir``; then the GLM driver
off and on again, after the profiler has run in the process. Every run
writes a fresh output directory and ends synchronized. Prints the card's
name and power limit, then one JSON line per run (driver, arm, wall
seconds, the driver's stage seconds, the run file's bytes). Needs one CUDA
card; run it from the root of a checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("telemetry_overhead: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    cs._cuda.build()
    cs.native_build.build()
    work = tempfile.mkdtemp(prefix="_game_cli-", dir=os.getcwd())
    try:
        data = cs.game_cli_data(dev, work)
        cfg = os.path.join(work, "config-2.json")
        with open(cfg, "w") as f:
            json.dump(cs.game_cli_config(data.effects, 2).to_dict(), f)
        runs = [0]

        def run(driver: str, arm: str) -> None:
            runs[0] += 1
            out, tel = os.path.join(work, f"out-{runs[0]}"), os.path.join(work, f"tel-{runs[0]}")
            flags = []
            if arm != "off":
                flags += ["--telemetry-dir", tel]
            if arm == "on+profiler":
                flags += ["--profile-dir", os.path.join(work, f"prof-{runs[0]}")]
            if driver == "glm_streamed":
                module, argv = cs.cli_train_glm, cs.glm_streamed_argv(dev, work, out)
            else:
                module = cs.cli_train
                argv = ["--config", cfg, "--train-data", os.path.join(work, "train"), "--validation-data",
                        os.path.join(work, "val"), "--output-dir", out, "--device", dev.type]
            with cs.stage_times(module) as stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                module.main(argv + flags)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            jsonl = os.listdir(tel) if arm != "off" else []
            print(json.dumps(dict(driver=driver, arm=arm, wall_s=wall, stages_s=stages,
                                  jsonl_bytes=[os.path.getsize(os.path.join(tel, f)) for f in jsonl])),
                  flush=True)
            shutil.rmtree(out, ignore_errors=True)

        for driver in ("glm_streamed", "game"):
            for arm in ("off", "on", "on", "off"):
                run(driver, arm)
        run("game", "on+profiler")
        for arm in ("off", "on"):
            run("glm_streamed", arm)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
