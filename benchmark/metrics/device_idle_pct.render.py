"""device_idle_pct.render: the share of the profiled window of back-to-back
calls in which no kernel, copy or set ran on the device, in %."""


def read(rec):
    p = rec.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
