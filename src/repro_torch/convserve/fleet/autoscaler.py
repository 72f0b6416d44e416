"""Telemetry-driven elasticity: grow/shrink the fleet from live signals.

The controller reads two signals every `tick_interval_s` of clock time:

  * **queue pressure** -- the scheduler's queue depth per READY replica,
  * **deadline slack** -- seconds to spare at completion (negative =
    missed), fed per wave by the fleet runtime,

both EWMA-smoothed so a single burst wave cannot flap the fleet.
Decisions are hysteretic and rate-limited: scale-up needs pressure
above `queue_high` (or slack below `slack_min_s`), scale-down needs
pressure below the *separate, lower* `queue_low` AND comfortable slack,
and any scale decision starts a `cooldown_s` window in which only
failure replacement may act.  Replacement is the exception on purpose:
a crashed replica is re-added toward `min_replicas` immediately --
waiting out a cooldown during an outage would be the controller
amplifying the fault.

While new replicas warm (`startup_s`), the controller exposes an
**admission cap**: the fleet runtime sheds load above what the READY
replicas can plausibly drain (reason-coded ``scaling`` rejections)
instead of building a queue the newcomers will answer too late.  Scale
events also bracket the adapt loop's shadow traffic (pause on first
action, resume when the fleet is steady again) so replanning evidence
is never collected while the fleet is reshaping.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, List, Optional

from repro_torch.convserve.fleet.pool import ElasticPool
from repro_torch.convserve.obs.trace import CAT_SCALE, NULL_TRACER
from repro_torch.convserve.runtime.clock import Clock


@dataclasses.dataclass
class AutoscalerConfig:
    """Elasticity knobs.  `queue_high`/`queue_low` are per-READY-replica
    EWMA queue depths (hysteresis band); `slack_min_s` is the smoothed
    deadline slack below which the fleet is about to miss SLOs."""

    min_replicas: int = 1
    max_replicas: int = 8
    tick_interval_s: float = 5.0
    queue_high: float = 12.0
    queue_low: float = 1.0
    slack_min_s: float = 0.0
    slack_comfort_s: float = 0.05  # scale-down needs at least this
    ewma: float = 0.3
    cooldown_s: float = 30.0
    step: int = 1  # replicas per scale decision
    admission_queue_per_replica: float = 32.0  # cap during scale-up
    # stale-telemetry guard: a scale decision whose telemetry stamp has
    # not advanced since the previous decision (or whose last mutation
    # is older than `stale_after_s`) is counted + audited, and -- with
    # `require_fresh_telemetry` -- blocked.  Replacement is exempt:
    # re-adding a crashed replica on stale data beats not re-adding it.
    require_fresh_telemetry: bool = False
    stale_after_s: Optional[float] = None

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.queue_low >= self.queue_high:
            raise ValueError(
                "hysteresis needs queue_low < queue_high "
                f"(got {self.queue_low} >= {self.queue_high})"
            )


class Autoscaler:
    """The fleet's elastic pool controller (pure logic over an injected
    clock reading -- the fleet runtime calls `tick` from its loop)."""

    def __init__(
        self,
        pool: ElasticPool,
        cfg: AutoscalerConfig,
        *,
        clock: Optional[Clock] = None,
        queue_depth_fn: Callable[[], int] = lambda: 0,
        on_scale_start: Optional[Callable[[str], None]] = None,
        on_scale_end: Optional[Callable[[], None]] = None,
        telemetry=None,
        tracer=None,
    ):
        self.pool = pool
        self.cfg = cfg
        self.clock = clock or pool.clock
        self.queue_depth_fn = queue_depth_fn
        self.on_scale_start = on_scale_start
        self.on_scale_end = on_scale_end
        self.telemetry = telemetry  # freshness-stamp source (optional)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        now = self.clock.now()
        self._lock = threading.Lock()
        self.q_ewma = 0.0  # guarded-by: _lock
        self.slack_ewma: Optional[float] = None  # guarded-by: _lock
        self._next_tick_t = now + cfg.tick_interval_s  # guarded-by: _lock
        self._last_scale_t = -math.inf  # guarded-by: _lock
        self._scaling_until = -math.inf  # guarded-by: _lock
        self._scale_active = False  # guarded-by: _lock
        self.ticks = 0  # guarded-by: _lock
        self.scale_ups = 0  # guarded-by: _lock
        self.scale_downs = 0  # guarded-by: _lock
        self.replacements = 0  # guarded-by: _lock
        self.stale_decisions = 0  # guarded-by: _lock
        self._last_decision_seq = -1  # guarded-by: _lock
        self.events: List[dict] = []  # guarded-by: _lock (audit trail)

    # -------------------------------------------------------- signals

    def note_slack(self, slack_s: float) -> None:
        """Feed one wave's worst-case deadline slack (completion time
        margin; negative = the wave missed) into the smoothed signal."""
        a = self.cfg.ewma
        with self._lock:
            if self.slack_ewma is None:
                self.slack_ewma = slack_s
            else:
                self.slack_ewma = (1 - a) * self.slack_ewma + a * slack_s

    # ----------------------------------------------------- admission

    def scaling(self, now: float) -> bool:
        """True while a scale-up's newcomers are still warming -- the
        window in which the fleet runtime applies the admission cap."""
        with self._lock:
            return now < self._scaling_until

    def admission_cap(self) -> float:
        """Max total queue depth to admit into during a scale-up: what
        the currently READY replicas can plausibly drain."""
        return (
            max(1, self.pool.ready_count())
            * self.cfg.admission_queue_per_replica
        )

    # ----------------------------------------------------------- tick

    def next_tick(self) -> float:
        with self._lock:
            return self._next_tick_t

    def tick(self, now: float) -> Optional[str]:
        """Run the control loop if a tick is due.  Returns the action
        taken ("up"/"down"/"replace"/None)."""
        cfg = self.cfg
        with self._lock:
            if now < self._next_tick_t:
                return None
            while self._next_tick_t <= now:
                self._next_tick_t += cfg.tick_interval_s
            self.ticks += 1
            ready = self.pool.ready_count()
            q = self.queue_depth_fn() / max(1, ready)
            self.q_ewma = (1 - cfg.ewma) * self.q_ewma + cfg.ewma * q
            q_ewma = self.q_ewma
            slack = self.slack_ewma
            cooled = now - self._last_scale_t >= cfg.cooldown_s
        live = self.pool.live_count()
        stamp = self.telemetry.stamp() if self.telemetry is not None else None

        action = None
        if live < cfg.min_replicas:
            # failure replacement: exempt from cooldown by design
            n = cfg.min_replicas - live
            born = self.pool.grow(n, now=now)
            if born:
                action = "replace"
                with self._lock:
                    self.replacements += len(born)
                    self._scaling_until = now + self.pool.startup_s
                self._record(now, action, len(born), "below min_replicas",
                             q_ewma, slack)
        elif cooled and live < cfg.max_replicas and (
            q_ewma > cfg.queue_high
            or (slack is not None and slack < cfg.slack_min_s)
        ) and not self._stale_guard(now, "up", stamp, q_ewma, slack):
            n = min(cfg.step, cfg.max_replicas - live)
            born = self.pool.grow(n, now=now)
            if born:
                action = "up"
                why = (
                    f"queue ewma {q_ewma:.1f} > {cfg.queue_high}"
                    if q_ewma > cfg.queue_high
                    else f"slack ewma {slack:.3f}s < {cfg.slack_min_s}s"
                )
                with self._lock:
                    self.scale_ups += 1
                    self._last_scale_t = now
                    self._scaling_until = now + self.pool.startup_s
                    if stamp is not None:
                        self._last_decision_seq = stamp["seq"]
                self._record(now, action, len(born), why, q_ewma, slack)
        elif (
            cooled
            and live > cfg.min_replicas
            and q_ewma < cfg.queue_low
            and (slack is None or slack > cfg.slack_comfort_s)
            and not self._stale_guard(now, "down", stamp, q_ewma, slack)
        ):
            gone = self.pool.retire(cfg.step, now=now)
            if gone:
                action = "down"
                with self._lock:
                    self.scale_downs += 1
                    self._last_scale_t = now
                    if stamp is not None:
                        self._last_decision_seq = stamp["seq"]
                self._record(
                    now, action, len(gone),
                    f"queue ewma {q_ewma:.1f} < {cfg.queue_low}",
                    q_ewma, slack,
                )

        self._bracket_scale_window(now, action)
        return action

    def _stale_guard(self, now, action, stamp, q_ewma, slack) -> bool:
        """True when a would-be `action` must be blocked because the
        telemetry snapshot is stale.  Stale = the stamp's seq has not
        advanced since the previous scale decision, or its last mutation
        is older than `stale_after_s`.  Every stale decision is counted
        and audited; only `require_fresh_telemetry` turns the audit into
        a veto (replacement never routes through here)."""
        if stamp is None:
            return False
        cfg = self.cfg
        with self._lock:
            seq_stale = stamp["seq"] == self._last_decision_seq
        age = (
            now - stamp["t"]
            if stamp["t"] is not None and cfg.stale_after_s is not None
            else None
        )
        age_stale = age is not None and age > cfg.stale_after_s
        if not seq_stale and not age_stale:
            return False
        why = (
            f"telemetry seq {stamp['seq']} unchanged since last decision"
            if seq_stale else f"telemetry age {age:.3f}s > "
            f"{cfg.stale_after_s}s"
        )
        with self._lock:
            self.stale_decisions += 1
        if self.telemetry is not None:
            self.telemetry.inc("autoscaler.stale_snapshot")
        self.tracer.instant(
            "scale.stale_snapshot", CAT_SCALE, action=action,
            seq=stamp["seq"],
            blocked=cfg.require_fresh_telemetry,
        )
        self._record(now, f"stale:{action}", 0, why, q_ewma, slack)
        return cfg.require_fresh_telemetry

    def _record(self, now, action, n, why, q_ewma, slack) -> None:
        with self._lock:
            self.events.append({
                "t": now, "action": action, "n": n, "why": why,
                "queue_ewma": round(q_ewma, 3),
                "slack_ewma": None if slack is None else round(slack, 4),
            })
        self.tracer.instant(
            f"scale.{action}", CAT_SCALE, n=n, why=why,
        )

    def _bracket_scale_window(self, now: float, action) -> None:
        """Pause/resume hooks around the reshaping window: first action
        fires `on_scale_start`; `on_scale_end` fires on the first steady
        tick after every newcomer is READY and every drain finished."""
        counts = self.pool.counts()
        reshaping = (
            counts.get("starting", 0) > 0
            or counts.get("draining", 0) > 0
            or action is not None
        )
        with self._lock:
            was = self._scale_active
            if reshaping:
                self._scale_active = True
            elif was and now >= self._scaling_until:
                self._scale_active = False
            fire_start = reshaping and not was
            fire_end = was and not self._scale_active
        if fire_start and self.on_scale_start is not None:
            self.on_scale_start(action or "reshape")
        if fire_end and self.on_scale_end is not None:
            self.on_scale_end()

    # ---------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "replacements": self.replacements,
                "stale_decisions": self.stale_decisions,
                "queue_ewma": round(self.q_ewma, 3),
                "slack_ewma": (
                    None if self.slack_ewma is None
                    else round(self.slack_ewma, 4)
                ),
                "scale_active": self._scale_active,
                "events": self.events[-50:],
                "config": dataclasses.asdict(self.cfg),
            }
