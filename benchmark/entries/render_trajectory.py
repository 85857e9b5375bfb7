"""`BinauralRenderer.render_trajectory`: one mono source along a per-block
path, host numpy in, the stereo render on the card out (closed loop,
`harness/offline.py`)."""

from benchmark.harness.offline import Offline


class Entry(Offline):
    method = "render_trajectory"
    squeeze = True
