"""The fleet serving runtime: `ServeRuntime` over an `ElasticPool`.

`FleetRuntime` is a subclass, not a fork: admission, wave formation,
telemetry, and the results contract are inherited.  What changes:

  * **the loop is a discrete-event simulation** under a `SimClock`:
    instead of sleeping on condition variables (which never fire when
    time is simulated), `run_until`/`drain` step the clock exactly onto
    the next scheduled instant -- a wave completion, a replica becoming
    ready, an injected fault, a health probe, an autoscaler tick, or a
    bucket's deadline flush -- and let the pool resolve it.  A simulated
    million-user day runs in seconds of wall time with exact latency
    stamps.  Under a `RealClock` everything delegates to the parent
    (the elastic pool executes inline).
  * **admission knows about elasticity**: while a scale-up's newcomers
    warm, requests above what the READY replicas can drain are rejected
    with the reason-coded ``scaling`` rejection instead of queueing for
    replicas that do not exist yet.
  * **loss is a first-class outcome**: a wave the pool could not serve
    (crashed replicas, retries exhausted) resolves to `WaveLoss`; the
    runtime records every rider's rid under `losses[rid] = reason` and
    counts ``lost``/``lost.<reason>`` telemetry, so the accounting
    invariant *admitted == served + lost* holds under any fault
    schedule -- no request ever vanishes.
  * **scale events bracket the adapt loop**: the autoscaler's
    start/end hooks pause and resume shadow replanning traffic, so
    measured evidence never straddles a fleet reshape.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from repro_torch.convserve.fleet.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.convserve.fleet.pool import ElasticPool, WaveLoss
from repro_torch.convserve.obs.trace import CAT_WAVE, attach as attach_tracer
from repro_torch.convserve.runtime.clock import Clock
from repro_torch.convserve.runtime.queueing import (
    REJECT_SCALING,
    Rejection,
    STANDARD,
)
from repro_torch.convserve.runtime.replicas import WaveResult
from repro_torch.convserve.runtime.scheduler import RuntimeConfig
from repro_torch.convserve.runtime.service import ServeRuntime
from repro_torch.convserve.runtime.telemetry import Telemetry


class FleetRuntime(ServeRuntime):
    """Elastic, fault-tolerant serving over a replica fleet."""

    def __init__(
        self,
        pool: ElasticPool,
        cfg: RuntimeConfig,
        *,
        clock: Optional[Clock] = None,
        telemetry: Optional[Telemetry] = None,
        autoscaler: Optional[AutoscalerConfig] = None,
        adapt=None,
        tracer=None,
        recorder=None,
    ):
        super().__init__(
            pool, cfg, clock=clock, telemetry=telemetry,
            tracer=tracer, recorder=recorder,
        )
        self.pool: ElasticPool = pool
        if self.tracer.active and not pool.tracer.active:
            # the pool emits the lifecycle/fault/loss instants; share the
            # runtime's ring unless the pool was given its own tracer
            pool.tracer = self.tracer
            for ex in pool.executors:
                attach_tracer(ex, self.tracer)
        self.adapt = adapt  # a replanner exposing pause()/resume()
        self.losses: Dict[int, str] = {}  # rid -> reason; guarded-by: _lock
        self.autoscaler = (
            Autoscaler(
                pool,
                autoscaler,
                clock=self.clock,
                queue_depth_fn=self.scheduler.depth,
                on_scale_start=self._on_scale_start,
                on_scale_end=self._on_scale_end,
                telemetry=self.telemetry,
                tracer=self.tracer,
            )
            if autoscaler is not None
            else None
        )

    # -------------------------------------------------- scale events

    def _on_scale_start(self, action: str) -> None:
        self.telemetry.inc("scale_events")
        self.telemetry.inc(f"scale_events.{action}")
        if self.adapt is not None:
            self.adapt.pause(reason=f"scale_event:{action}")

    def _on_scale_end(self) -> None:
        self.telemetry.inc("scale_events.settled")
        if self.adapt is not None:
            self.adapt.resume()

    # ------------------------------------------------------ admission

    def submit(
        self,
        image: np.ndarray,
        *,
        rid: Optional[int] = None,
        priority: int = STANDARD,
        deadline_s: Optional[float] = None,
    ) -> Optional[Rejection]:
        auto = self.autoscaler
        if (
            auto is not None
            and auto.scaling(self.clock.now())
            and self.scheduler.depth() >= auto.admission_cap()
        ):
            with self._lock:
                if rid is None:
                    rid = self._next_rid
                self._next_rid = max(self._next_rid, rid) + 1
            rej = Rejection(
                rid=rid,
                reason=REJECT_SCALING,
                detail=(
                    "scale-up in progress: queue at the READY replicas' "
                    f"admission cap ({auto.admission_cap():.0f})"
                ),
            )
            self.telemetry.inc("rejected")
            self.telemetry.inc(f"rejected.{REJECT_SCALING}")
            with self._lock:
                self.rejections[rid] = rej
            return rej
        return super().submit(
            image, rid=rid, priority=priority, deadline_s=deadline_s
        )

    # ------------------------------------------------------- dispatch

    def poll(self) -> int:
        """Resolve due pool events and run the autoscaler before
        dispatching -- completions free replicas and scale decisions
        change capacity, and both must be visible to the capacity gate."""
        now = self.clock.now()
        self.pool.advance(now)
        if self.autoscaler is not None:
            self.autoscaler.tick(now)
        return super().poll()

    def _on_done(self, fut) -> None:
        exc = fut.exception()
        if isinstance(exc, WaveLoss):
            wave = exc.wave
            self.telemetry.inc("lost_waves")
            self.telemetry.inc(f"lost.{exc.reason}")
            self.telemetry.inc("lost_images", len(wave.requests))
            self._close_wave_span(fut, wave, lost=True, reason=exc.reason)
            self.tracer.instant(
                "wave.lost", CAT_WAVE, reason=exc.reason,
                n=len(wave.requests),
            )
            with self._done_cv:
                for r in wave.requests:
                    self.losses[r.rid] = exc.reason
                self._outstanding -= 1
                self._done_cv.notify_all()
            # close the riders' request spans: the loss IS their outcome
            for r in wave.requests:
                with self._lock:
                    rsid = self._req_spans.pop(r.rid, 0)
                self.tracer.end(rsid, lost=True, reason=exc.reason)
            if self.recorder is not None:
                self.recorder.trip(
                    "wave_loss", loss=exc.reason, n=len(wave.requests)
                )
            return
        super()._on_done(fut)
        if exc is None and self.autoscaler is not None:
            res: WaveResult = fut.result()
            done = self.clock.now()
            slack = min(
                (r.deadline - done for r in res.wave.requests
                 if not math.isinf(r.deadline)),
                default=None,
            )
            if slack is not None:
                self.autoscaler.note_slack(slack)

    # ------------------------------------------------------- the loop

    def _next_wake(self, now: float, t_target: float) -> float:
        """Earliest strictly-future scheduled instant: pool event
        (completion / replica-ready / fault / probe), autoscaler tick,
        or bucket deadline flush -- bounded by the target."""
        cands = [self.scheduler.next_event(now), self.pool.next_event()]
        if self.autoscaler is not None:
            cands.append(self.autoscaler.next_tick())
        future = [t for t in cands if t > now and not math.isinf(t)]
        return min(future, default=t_target) if t_target >= now else now

    def run_until(self, t_target: float) -> None:
        if self.clock.realtime:
            return super().run_until(t_target)
        while True:
            self.poll()
            now = self.clock.now()
            if now >= t_target:
                return
            wake = min(self._next_wake(now, t_target), t_target)
            if wake > now:
                self.clock.sleep(wake - now)
            # wake == now: an instant just crossed; loop and poll again

    def drain(self) -> None:
        if self.clock.realtime:
            return super().drain()
        while True:
            self.poll()
            now = self.clock.now()
            if self.pool.has_capacity() and self.scheduler.depth():
                wave = self.scheduler.drain_wave(now)
                if wave is not None:
                    self._dispatch(wave)
                    continue
            with self._done_cv:
                outstanding = self._outstanding
            if not outstanding and not self.scheduler.depth():
                return
            nxt = self.pool.next_event()
            if self.autoscaler is not None:
                nxt = min(nxt, self.autoscaler.next_tick())
            if math.isinf(nxt):
                # nothing scheduled can ever free capacity: the queued
                # waves are doomed -- dispatch them so they resolve to
                # reason-coded losses instead of hanging the drain
                if self.scheduler.depth():
                    wave = self.scheduler.drain_wave(now)
                    if wave is not None:
                        self._dispatch(wave)
                        continue
                self.pool.advance(float("inf"))
                continue
            if nxt > now:
                self.clock.sleep(nxt - now)

    # ---------------------------------------------------------- stats

    def stats(self, profile_bucket: Optional[int] = None) -> dict:
        doc = super().stats(profile_bucket)
        if self.autoscaler is not None:
            doc["autoscaler"] = self.autoscaler.stats()
        with self._lock:
            by_reason: Dict[str, int] = {}
            for reason in self.losses.values():
                by_reason[reason] = by_reason.get(reason, 0) + 1
            # always present (even all-zero) so the document schema is
            # stable across scale events and fault drills
            doc["losses"] = {
                "requests": len(self.losses),
                "by_reason": by_reason,
            }
        return doc
