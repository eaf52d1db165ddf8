"""Shared CLI helpers (port of ``photon_ml_tpu/cli/common.py``)."""

from __future__ import annotations

import json

from photon_ml_tpu_torch.config import GameTrainingConfig, parse_config


def load_training_config(path: str) -> GameTrainingConfig:
    with open(path) as f:
        return parse_config(json.load(f))


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a flag or setting whose branch waits for a ROADMAP
    queue 1 item."""
    return NotImplementedError(f"{what} waits for ROADMAP queue 1 item {item}")
