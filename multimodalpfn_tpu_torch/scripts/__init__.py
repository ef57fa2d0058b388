"""The port's command-line entry points, counterparts of the JAX package's
``scripts/``: ``python -m multimodalpfn_tpu_torch.scripts.<name>`` with
``finetune_cli``, ``run_experiment`` or ``run_published``. Each runs on the
card unless ``--device cpu`` is given, and ``main(argv)`` returns what it
prints."""

from __future__ import annotations

from pathlib import Path

import torch

# the repository root, where ``configs/`` lives
REPO = Path(__file__).resolve().parents[2]


def cli_device(name: str) -> torch.device:
    """The device a CLI runs on. A CUDA device is never replaced by the CPU:
    without CUDA it raises, and the caller asks for the CPU with
    ``--device cpu``."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} was requested but CUDA is not available; pass --device cpu to run on the CPU"
        )
    return device
