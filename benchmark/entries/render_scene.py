"""`BinauralRenderer.render_scene`: S moving sources, each along its own
per-block path, mixed down to stereo on the card (closed loop,
`harness/offline.py`)."""

from benchmark.harness.offline import Offline


class Entry(Offline):
    method = "render_scene"
