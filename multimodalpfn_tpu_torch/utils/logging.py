"""Logging configuration (console + file), mirroring the reference's
dictConfig setup (`scripts_finetune_mm/finetune_mmpfn_main.py:41-68`, which logs
to ./logs/finetune_tabpfn.log). The port of the JAX package's
`multimodalpfn_tpu/utils/logging.py`; the logger is the port's."""

from __future__ import annotations

import logging
from pathlib import Path

FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def setup_logging(
    *,
    level: int = logging.INFO,
    log_file: str | Path | None = "logs/finetune_mmpfn.log",
    name: str = "multimodalpfn_tpu_torch",
) -> logging.Logger:
    """Replace the handlers of the logger ``name`` by a console handler and,
    unless ``log_file`` is None, a file handler, both at ``level`` in the
    reference's format; the logger does not propagate. The JAX package sets
    up the same through ``logging.config.dictConfig``, which also closes every
    other handler of the process (a caller's, a test runner's); this one
    touches the logger ``name`` alone."""
    logger = logging.getLogger(name)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(str(log_file)))
    for handler in handlers:
        handler.setFormatter(logging.Formatter(FORMAT))
        handler.setLevel(level)
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger
