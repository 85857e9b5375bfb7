"""Render-time ops: direction lookup, filter assembly, overlap-add, and the
block-render and partitioned-convolution kernels."""
