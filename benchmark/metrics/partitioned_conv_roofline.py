"""partitioned_conv_roofline: the least time of the stage `partitioned_conv`
implements at the cell's shapes (`partitioned_conv` in
`harness/work_partitioned.py`) over the kernel's device time a call in
the profiled window (all its launches), in %. Nothing when the trace
holds no record of the kernel (the route took another)."""

from benchmark.harness import work, work_partitioned


def read(rec):
    p = rec.profile
    if p is None:
        return None
    return work.roofline_pct(work_partitioned.partitioned_conv, rec.shapes,
                             p.per_call_s("partitioned_conv"))
