"""assemble_partitions_roofline: the least time of the stage `assemble_partitions`
implements at the cell's shapes (`assemble_partitions` in
`harness/work_partitioned.py`) over the kernel's device time a call in
the profiled window (all its launches), in %. Nothing when the trace
holds no record of the kernel (the route took another)."""

from benchmark.harness import work, work_partitioned


def read(rec):
    p = rec.profile
    if p is None:
        return None
    return work.roofline_pct(work_partitioned.assemble_partitions, rec.shapes,
                             p.per_call_s("assemble_partitions"))
