"""Renderers."""

from .renderer import BinauralRenderer, render_scene, render_trajectory
from .streaming import BatchedStream, Stream, StreamState, init_state

__all__ = ["BinauralRenderer", "render_trajectory", "render_scene", "Stream",
           "BatchedStream", "StreamState", "init_state"]
