"""Shared CLI helpers (port of ``photon_ml_tpu/cli/common.py``)."""

from __future__ import annotations

import json

from photon_ml_tpu_torch.config import GameTrainingConfig, parse_config


def load_training_config(path: str) -> GameTrainingConfig:
    with open(path) as f:
        return parse_config(json.load(f))

