"""Utilities: trajectory paths, profiling, logging."""

from .log import configure as configure_logging, get_logger
from .paths import circular_sweep, waypoints_to_block_dirs
from .profiling import (clear, count, counters, enable_debug_checks, fence,
                        marginal_cost, marginal_cost_ab, span, spans, trace,
                        tracing)

__all__ = [
    "circular_sweep",
    "waypoints_to_block_dirs",
    "fence",
    "enable_debug_checks",
    "marginal_cost",
    "marginal_cost_ab",
    "trace",
    "span",
    "tracing",
    "count",
    "counters",
    "spans",
    "clear",
    "get_logger",
    "configure_logging",
]
