"""host_ms.blockify: the self time of the program's span ``tt.blockify``
(`_blockify`'s host part: `np.asarray` to float32, `np.pad` to whole
blocks into fresh pages, and their release after the copy; the copy is
its child ``tt.h2d``, left out) in ms a call, the mean over the profiled
calls (host clock, `harness/spans.py`). Nothing where the program records
no spans."""

from benchmark.harness import spans


def read(rec):
    return spans.mean_ms(rec, "tt.blockify")
