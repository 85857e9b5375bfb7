"""Utilities: trajectory paths and logging."""

from .log import configure as configure_logging, get_logger
from .paths import circular_sweep, waypoints_to_block_dirs

__all__ = [
    "circular_sweep",
    "waypoints_to_block_dirs",
    "get_logger",
    "configure_logging",
]
