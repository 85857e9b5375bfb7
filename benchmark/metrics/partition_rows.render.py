"""partition_rows.render: the filter rows × partitions the partitioned
route assembles a call (the program's counter ``partition_rows``; each
chunk past the first assembles its predecessor row again), the mean over
the profiled calls (`harness/spans.py`). Nothing where the program records
no spans, or no call counted partitions (a program without the counter,
or a route without the stage)."""

from benchmark.harness import spans


def read(rec):
    if not any("partition_rows" in r.counts for r, _ in spans.calls(rec)):
        return None
    return spans.mean_count(rec, "partition_rows")
