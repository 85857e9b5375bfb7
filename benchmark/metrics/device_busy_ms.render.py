"""device_busy_ms.render: device time a call, in ms: the union of every
kernel, copy and set in the profiled window (spins left out) over its
calls."""


def read(rec):
    p = rec.profile
    if p is None or p.busy_s <= 0:
        return None
    return 1e3 * p.busy_s / p.calls
