"""The program's own spans of the profiled calls, for the per-layer
metrics that read them (``host_ms.blockify``, ``host_ms.dedupe``,
``host_ms.lookup``, ``host_ms.route``, ``h2d_gbps.render``,
``host_syncs.render``).

The program records a span at each of its layer boundaries while a
`torch.profiler` session records (`tinaural_torch.utils.profiling`), so
a ``--trace 1`` run's profiled calls leave theirs in the program's ring:
one root a call (``tt.render_trajectory``, ``tt.render_scene``) holding
its layers' spans, and the change of each program counter during the
call. `profile.run` may take its trace up to three times; the last
``calls`` roots are those of the trace it kept. A program without the
registry gives no calls, and the readers nothing.

These host times come from profiled calls, so they include the
profiler's own cost for each torch op a span holds.
"""

from __future__ import annotations


def calls(rec) -> list[tuple]:
    """[(root, [its spans])] of the profiled window's calls; [] without a
    profile or a registry."""
    p = rec.profile
    if p is None:
        return []
    try:
        from tinaural_torch.utils.profiling import spans
    except ImportError:
        return []
    ring = spans()
    roots = [s for s in ring if s.parent is None][-p.calls:]
    held = {r.call: [] for r in roots}
    for s in ring:
        if s.parent is not None and s.call in held:
            held[s.call].append(s)
    return [(r, held[r.call]) for r in roots]


def ns_in(spans, name: str) -> int:
    """Nanoseconds in the spans named ``name``."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name)


def self_ns(spans, name: str) -> int:
    """Nanoseconds in the spans named ``name`` less the part of each that
    its own spans cover (``spans``: one call's)."""
    ids = {s.id for s in spans if s.name == name}
    inner = sum(s.end_ns - s.start_ns for s in spans if s.parent in ids)
    return ns_in(spans, name) - inner


def mean_ms(rec, name: str) -> float | None:
    """Milliseconds a call in spans named ``name``, less the spans they
    hold (their self time), the mean over the profiled calls; None where
    no call holds one."""
    got = calls(rec)
    if not any(s.name == name for _, held in got for s in held):
        return None
    return sum(self_ns(held, name) for _, held in got) / len(got) / 1e6


def mean_count(rec, counter: str) -> float | None:
    """The program counter's change a call, the mean over the profiled
    calls; None without calls."""
    got = calls(rec)
    if not got:
        return None
    return sum(r.counts.get(counter, 0) for r, _ in got) / len(got)
