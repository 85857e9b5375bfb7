"""Renderers."""

from .renderer import BinauralRenderer, render_scene, render_trajectory

__all__ = ["BinauralRenderer", "render_trajectory", "render_scene"]
