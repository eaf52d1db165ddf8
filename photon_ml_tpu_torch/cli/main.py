"""``photon-ml-tpu-torch`` umbrella entry point (console script; port of
``photon_ml_tpu/cli/main.py``).

Subcommand dispatch over the port's drivers — each stays runnable as
``python -m photon_ml_tpu_torch.cli.<driver>`` too; this wrapper only maps
``photon-ml-tpu-torch <subcommand> ...`` onto the same ``main(argv)``
hooks. The commands are the reference's: ``lint`` runs the port's own
checker (``photon_ml_tpu_torch/analysis``) over the port's tree.
"""

from __future__ import annotations

import sys


def _commands() -> dict:
    # lazy imports: printing the usage must not pay for (or fail on)
    # torch or a driver's imports
    return {
        "train": "photon_ml_tpu_torch.cli.train",
        "score": "photon_ml_tpu_torch.cli.score",
        "train-glm": "photon_ml_tpu_torch.cli.train_glm",
        "index-features": "photon_ml_tpu_torch.cli.index_features",
        "name-term-bags": "photon_ml_tpu_torch.cli.name_term_bags",
        "report": "photon_ml_tpu_torch.cli.report",
        "lint": "photon_ml_tpu_torch.cli.lint",
        "serve": "photon_ml_tpu_torch.cli.serve",
    }


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    commands = _commands()
    if not argv or argv[0] in ("-h", "--help"):
        names = "  ".join(sorted(commands))
        print(f"usage: photon-ml-tpu-torch <command> [args...]\ncommands: {names}")
        raise SystemExit(0 if argv else 2)
    cmd = argv[0]
    if cmd not in commands:
        raise SystemExit(
            f"unknown command {cmd!r}; one of: {', '.join(sorted(commands))}"
        )
    import importlib

    importlib.import_module(commands[cmd]).main(argv[1:])


if __name__ == "__main__":
    main()
