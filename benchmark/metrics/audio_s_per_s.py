"""audio_s_per_s: source-audio seconds completed (S·N/sample rate a
render), summed over every call of the window, over the window's wall time
from its start to the last call's end (host clock)."""


def read(rec):
    if not rec.work:
        return None
    return sum(rec.work) / rec.window.seconds
