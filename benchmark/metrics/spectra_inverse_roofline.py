"""spectra_inverse_roofline: the least time of the stage
`spectra_inverse` implements at the cell's shapes (`spectra_inverse` in
`harness/work_natural.py`: one inverse a block row, no sum over sources)
over the kernel's device time a call in the profiled window, in %.
Nothing when the trace holds no record of the kernel (the route took
another)."""

from benchmark.harness import work, work_natural


def read(rec):
    p = rec.profile
    if p is None:
        return None
    return work.roofline_pct(work_natural.spectra_inverse, rec.shapes,
                             p.per_call_s("spectra_inverse"))
