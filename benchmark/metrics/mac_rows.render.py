"""mac_rows.render: the rows the natural-order kernel assembles and
multiplies a call (the program's counter ``mac_rows``: S·nb at every
``dir_rate``), the mean over the profiled calls (`harness/spans.py`).
Nothing where the program records no spans, or no call counted the rows
(a program without the counter, or a route without the kernel)."""

from benchmark.harness import spans


def read(rec):
    if not any("mac_rows" in r.counts for r, _ in spans.calls(rec)):
        return None
    return spans.mean_count(rec, "mac_rows")
