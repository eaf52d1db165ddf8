"""Leveled run logging and stage timers (port of
``photon_ml_tpu/utils/logging.py``): the reference's ``PhotonLogger`` (a
leveled log file in the job's output directory) and ``Timed`` stage
wrappers. WARN and ERROR lines also go to the run's telemetry JSONL as
``log`` records (``obs.emit_log``) while a sink is active."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator, TextIO


class PhotonLogger:
    """Logs to stderr and, given ``output_dir``, appends to a file there
    (opened per line, so the logger holds no open file).

    Levels: DEBUG < INFO < WARN < ERROR. The instance is callable with a
    plain message (INFO), so it serves wherever a ``logger`` callback is
    taken (the estimator, coordinate descent).

    ``event_hook(level, message, fields)`` receives every WARN and ERROR
    line with its keyword fields; ``None`` (the default) is the telemetry
    sink's ``emit_log`` (a no-op with no sink), ``False`` turns it off."""

    LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}

    def __init__(
        self,
        output_dir: str | None = None,
        level: str = "INFO",
        stream: TextIO | None = None,
        filename: str = "photon.log",
        event_hook=None,
    ):
        self.level = self.LEVELS[level.upper()]
        self.stream = stream if stream is not None else sys.stderr
        self._event_hook = event_hook
        self._path = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self._path = os.path.join(output_dir, filename)

    def log(self, level: str, msg: str, **fields) -> None:
        if self.LEVELS[level] < self.level:
            return
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {level:5s} {msg}"
        print(line, file=self.stream)
        if self._path is not None:
            with open(self._path, "a") as f:
                print(line, file=f)
        if self.LEVELS[level] >= self.LEVELS["WARN"]:
            hook = self._event_hook
            if hook is None:
                from photon_ml_tpu_torch.obs import emit_log

                hook = emit_log
            if hook:
                try:
                    hook(level, msg, fields or None)
                except Exception:
                    pass  # telemetry never takes down the run it logs

    def debug(self, msg: str) -> None:
        self.log("DEBUG", msg)

    def info(self, msg: str) -> None:
        self.log("INFO", msg)

    def warn(self, msg: str, **fields) -> None:
        self.log("WARN", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self.log("ERROR", msg, **fields)

    def __call__(self, msg: str) -> None:
        self.info(msg)


@contextlib.contextmanager
def timed(logger: PhotonLogger, stage: str) -> Iterator[None]:
    """Log a stage's wall time (the reference's ``Timed`` wrapper)."""
    logger.info(f"{stage}: started")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info(f"{stage}: finished in {time.perf_counter() - t0:.2f}s")
