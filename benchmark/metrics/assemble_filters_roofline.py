"""assemble_filters_roofline: the least time of the stage `assemble_filters` implements at
the cell's shapes (assembly in `harness/work.py`) over the kernel's device time
a call in the profiled window, in %. Nothing when the trace holds no record
of the kernel (the route took another)."""

from benchmark.harness import work


def read(rec):
    p = rec.profile
    if p is None:
        return None
    return work.roofline_pct(work.assembly, rec.shapes, p.per_call_s("assemble_filters"))
