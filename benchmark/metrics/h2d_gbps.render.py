"""h2d_gbps.render: the bytes a call copies from host arrays to the card
(the program's counter ``h2d_bytes``: the blocks and the directions) over
the time in its spans ``tt.h2d`` (pageable copies, each waiting for the
stream), in GB/s (10^9 bytes/s), the mean over the profiled calls
(`harness/spans.py`). Nothing where the program records no spans."""

from benchmark.harness import spans


def read(rec):
    rates = [r.counts.get("h2d_bytes", 0) / ns
             for r, held in spans.calls(rec)
             if (ns := spans.ns_in(held, "tt.h2d")) > 0]
    return sum(rates) / len(rates) if rates else None
