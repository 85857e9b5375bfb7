"""host_ms.lookup: the program's span ``tt.lookup`` (`_neighbours`: the
~20 small torch ops of `direction_weights` and the row and weight
arithmetic, each enqueued on the card) in ms a call, the mean over the
profiled calls (host clock, `harness/spans.py`). The profiled calls pay
the profiler's own cost for each torch op, and this span holds most of a
call's ops, so it reads higher than an unprofiled call spends. Nothing
where the program records no spans."""

from benchmark.harness import spans


def read(rec):
    return spans.mean_ms(rec, "tt.lookup")
