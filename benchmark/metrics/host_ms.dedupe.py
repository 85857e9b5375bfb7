"""host_ms.dedupe: the program's span ``tt.dedupe`` (`render_scene`'s host
scan for sources on one snapped track, and their pre-mix) in ms a call,
the mean over the profiled calls (host clock, `harness/spans.py`).
Nothing where the program records no spans, or the entry point has no
dedupe."""

from benchmark.harness import spans


def read(rec):
    return spans.mean_ms(rec, "tt.dedupe")
