"""host_ms.route: the program's span ``tt.route`` (the route call: the
kernel wrappers' host work, their launches, and the wait of
`assemble_filters`' range check on the card) in ms a call, the mean over
the profiled calls (host clock, `harness/spans.py`). Nothing where the
program records no spans."""

from benchmark.harness import spans


def read(rec):
    return spans.mean_ms(rec, "tt.route")
