"""host_syncs.render: the times a call's host waits on the card (the
program's counter ``host_syncs``: each pageable host-to-device copy, and
`assemble_filters`' range check reading its answer back), a call, the
mean over the profiled calls (`harness/spans.py`). 0 off the card.
Nothing where the program records no spans."""

from benchmark.harness import spans


def read(rec):
    return spans.mean_count(rec, "host_syncs")
