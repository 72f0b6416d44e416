"""Fault tolerance: failure injection, straggler watchdog, supervised retry.

On a real cluster the coordinator restarts failed workers and the job
resumes from the last committed checkpoint; here the same control flow
is exercised with injected failures.  Pure Python: the port's copy of
`repro.runtime.fault`, with the same names and the same behaviour.
Two consumers share this module:

  * the training loop (`FailureInjector` + `run_supervised`): step-keyed
    node-loss injection with restore-from-checkpoint, and
  * the fleet serving pool (`FaultPlan`): a *time*-keyed schedule of
    replica crashes, slowdowns, and shared-cache corruption, routed
    through the injected `Clock` so the same drill replays identically
    under a `SimClock` (deterministic fault instants on the simulated
    timeline) and a `RealClock`.

All `FaultPlan` state is lock-guarded: the serving pool consults it from
replica completion threads as well as the dispatch path.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given steps (simulated node loss)."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


# fault kinds the fleet pool understands (a closed vocabulary, like the
# admission-reject reasons: telemetry and loss accounting count by it)
FAULT_CRASH = "crash"
FAULT_SLOW = "slow"
FAULT_CACHE_CORRUPT = "cache_corrupt"
FAULT_KINDS = (FAULT_CRASH, FAULT_SLOW, FAULT_CACHE_CORRUPT)


@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """One scheduled fault: at clock time `t`, do `kind` to `replica`.

    `replica` is the pool's replica index (`None` targets the shared
    kernel cache for ``cache_corrupt``; crash/slow require a target).
    `factor` is the service-time multiplier for ``slow`` faults."""

    t: float
    kind: str
    replica: Optional[int] = None
    factor: float = 4.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}"
            )
        if self.kind in (FAULT_CRASH, FAULT_SLOW) and self.replica is None:
            raise ValueError(f"{self.kind} fault needs a target replica")


class FaultPlan:
    """A deterministic, clock-routed schedule of injected faults.

    The pool polls ``due()`` as its event loop advances; each fault is
    handed out exactly once, in schedule order, the first time the
    injected clock reaches its instant.  ``next_t()`` lets a simulated
    event loop step the clock exactly onto the next fault (so a crash
    lands at a provable simulated instant, not "sometime during the
    trace")."""

    def __init__(
        self,
        faults: Sequence[ReplicaFault] = (),
        *,
        clock=None,
    ):
        self.clock = clock  # injected Clock; None = caller supplies `now`
        self._lock = threading.Lock()
        self._pending: List[ReplicaFault] = sorted(  # guarded-by: _lock
            faults, key=lambda f: f.t
        )
        self.fired: List[ReplicaFault] = []  # guarded-by: _lock

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        if self.clock is None:
            raise ValueError(
                "FaultPlan has no injected clock: pass `now` explicitly"
            )
        return self.clock.now()

    def due(self, now: Optional[float] = None) -> List[ReplicaFault]:
        """Pop every fault scheduled at or before `now` (the injected
        clock's reading when omitted), oldest first, each exactly once."""
        t = self._now(now)
        with self._lock:
            ripe = [f for f in self._pending if f.t <= t]
            if ripe:
                self._pending = [f for f in self._pending if f.t > t]
                self.fired.extend(ripe)
            return ripe

    def next_t(self) -> float:
        """Clock time of the next scheduled fault (inf when exhausted)."""
        with self._lock:
            return self._pending[0].t if self._pending else float("inf")

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending": len(self._pending),
                "fired": [
                    {"t": f.t, "kind": f.kind, "replica": f.replica}
                    for f in self.fired
                ],
            }


class StragglerWatchdog:
    """Step-time tracker: alarms when a step exceeds k x trailing p50.

    On a real deployment the alarm triggers work re-assignment / node
    replacement; here it records events for the supervisor + tests.
    With an injected `clock`, alarms are stamped with the clock's time,
    so a SimClock drill yields deterministic alarm timelines.
    """

    def __init__(self, factor: float = 3.0, window: int = 50,
                 min_steps: int = 5, *, clock=None):
        self.factor = factor
        self.window = window
        self.min_steps = min_steps
        self.clock = clock
        self.times: List[float] = []
        self.alarms: List[dict] = []

    def observe(self, step: int, seconds: float) -> Optional[dict]:
        alarm = None
        if len(self.times) >= self.min_steps:
            hist = sorted(self.times[-self.window :])
            p50 = hist[len(hist) // 2]
            if seconds > self.factor * p50:
                alarm = {"step": step, "seconds": seconds, "p50": p50}
                if self.clock is not None:
                    alarm["t"] = self.clock.now()
                self.alarms.append(alarm)
        self.times.append(seconds)
        return alarm


def run_supervised(
    work: Callable[[int], int],
    *,
    start_step: int,
    total_steps: int,
    restore: Callable[[], int],
    max_restarts: int = 5,
) -> int:
    """Supervisor loop: run `work(step) -> next_step` until total_steps,
    restoring from the last checkpoint (via `restore() -> step`) on failure.
    Models the cluster-level restart-from-checkpoint policy.
    """
    step = start_step
    restarts = 0
    while step < total_steps:
        try:
            step = work(step)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore()
    return step
