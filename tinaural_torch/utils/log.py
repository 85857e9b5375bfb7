"""Logging: stdlib logging under the ``tinaural_torch`` namespace; quiet by
default."""

from __future__ import annotations

import logging


def get_logger(name: str = "tinaural_torch") -> logging.Logger:
    return logging.getLogger(name)


def configure(level: int = logging.INFO) -> None:
    """Opt-in console logging, for the CLI and for debugging."""
    logger = get_logger()
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
