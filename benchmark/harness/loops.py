"""How a cell offers its load.

A closed loop sends the next call when the last has ended, one in flight,
as an offline renderer does. Each call is ``issue(i)`` (the entry point
until it returns) then ``finish(i, handle)`` (until its result is where
the user has it); each leaves a `Call` with its host clock readings, its
``due`` time the moment it could be sent.
"""

from __future__ import annotations

import dataclasses
import time

clock = time.perf_counter


@dataclasses.dataclass
class Call:
    due: float
    start: float
    returned: float
    end: float

    @property
    def latency_s(self) -> float:
        return self.end - self.due

    @property
    def host_s(self) -> float:
        return self.returned - self.start


@dataclasses.dataclass
class Window:
    calls: list
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def closed(issue, finish, seconds: float) -> Window:
    """Calls back to back until ``seconds`` have passed since the first
    started; the window ends when the last call ends."""
    calls = []
    t0 = clock()
    i = 0
    while True:
        s = clock()
        h = issue(i)
        r = clock()
        finish(i, h)
        e = clock()
        calls.append(Call(s, s, r, e))
        i += 1
        if e - t0 >= seconds:
            return Window(calls, t0, e)
