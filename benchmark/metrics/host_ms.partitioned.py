"""host_ms.partitioned: the program's spans ``tt.frames``,
``tt.partitions`` and ``tt.conv`` (the partitioned route's wrappers: their
host work and launches, chunk by chunk) in ms a call, their self time's
mean over the profiled calls (host clock, `harness/spans.py`). Nothing
where the program records none of them."""

from benchmark.harness import spans

SPANS = ("tt.frames", "tt.partitions", "tt.conv")


def read(rec):
    got = [spans.mean_ms(rec, name) for name in SPANS]
    if all(v is None for v in got):
        return None
    return sum(v for v in got if v is not None)
