"""host_ms.render: the benchmark's span around each entry call, from its
start until it returns (before the wait for its result), in ms: the mean
over the window's calls (host clock)."""


def read(rec):
    calls = rec.window.calls
    if not calls:
        return None
    return 1e3 * sum(c.host_s for c in calls) / len(calls)
