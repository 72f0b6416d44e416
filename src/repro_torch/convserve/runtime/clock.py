"""Injectable time source for the serving runtime.

Every runtime component that reasons about time -- admission stamps,
deadline slack, wave flushes, latency histograms -- reads it through a
`Clock` so the whole scheduler can run against a `SimClock` in tests:
deterministic, instant, and able to prove deadline behaviour (a partial
wave flushed at an exact simulated instant) without ever sleeping.
"""

from __future__ import annotations

import time


class Clock:
    """Monotonic seconds + sleep.  The interface both impls satisfy.

    `realtime` tells the runtime whether wall-clock measurements (wave
    compute times) are commensurable with this clock's timeline: under
    a `SimClock` they are not, and feeding them into the scheduler's
    slack model would make "deterministic" simulated scheduling depend
    on host speed.
    """

    realtime = True

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    """Wall time (`time.monotonic`): the production clock."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class SimClock(Clock):
    """Simulated time: `sleep` (and `advance`) move `now` forward
    instantly.  Starts at 0.0 so test timestamps read as offsets."""

    realtime = False

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot move time backwards ({seconds})")
        self._t += seconds
