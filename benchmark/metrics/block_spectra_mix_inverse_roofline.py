"""block_spectra_mix_inverse_roofline: the least time of the stage `block_spectra_mix_inverse` implements at
the cell's shapes (mix_inverse in `harness/work.py`) over the kernel's device time
a call in the profiled window, in %. Nothing when the trace holds no record
of the kernel (the route took another)."""

from benchmark.harness import work


def read(rec):
    p = rec.profile
    if p is None:
        return None
    return work.roofline_pct(work.mix_inverse, rec.shapes, p.per_call_s("block_spectra_mix_inverse"))
