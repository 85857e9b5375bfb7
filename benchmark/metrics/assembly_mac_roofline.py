"""assembly_mac_roofline: the least time of the stage `assembly_mac`
implements at the cell's shapes (`assembly_mac` in
`harness/work_natural.py`) over the kernel's device time a call in the
profiled window, in %. Nothing when the trace holds no record of the
kernel (the route took another)."""

from benchmark.harness import work, work_natural


def read(rec):
    p = rec.profile
    if p is None:
        return None
    return work.roofline_pct(work_natural.assembly_mac, rec.shapes,
                             p.per_call_s("assembly_mac"))
