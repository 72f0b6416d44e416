"""The online serving runtime: admit -> queue -> wave -> replica ->
telemetry.

`ServeRuntime` glues the deadline-aware `WaveScheduler` to a
`ReplicaPool` behind one submit/poll/drain surface:

    pool = ReplicaPool.build(engine, spec, weights, n=2)
    rt = ServeRuntime(pool, RuntimeConfig(buckets=(32, 64), slo_s=0.05))
    rt.submit(image, rid=0)      # None, or a Rejection (reason-coded)
    rt.poll()                    # dispatch every wave that is ready NOW
    rt.drain()                   # flush + wait for in-flight waves
    rt.results[0]                # (H', W', C')
    rt.stats()                   # the one telemetry JSON document

The runtime never owns a scheduling thread: `poll()` dispatches every
wave the scheduler considers ready at the injected clock's "now", and
`play()` replays an open-loop arrival trace, sleeping only until the
next arrival or the next deadline flush -- the same loop drives real
traffic (RealClock + threaded replicas) and deterministic tests
(SimClock + inline replicas) with identical scheduling decisions.
Request completions land on replica threads; results, counters, and
histograms are lock-protected.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.convserve.obs.trace import (
    CAT_REQUEST,
    CAT_WAVE,
    NULL_TRACER,
    attach as attach_tracer,
)
from repro_torch.convserve.runtime.clock import Clock, RealClock
from repro_torch.convserve.runtime.loadgen import Arrival
from repro_torch.convserve.runtime.queueing import Rejection, Request, STANDARD
from repro_torch.convserve.runtime.replicas import ReplicaPool, WaveResult, replica_device
from repro_torch.convserve.runtime.scheduler import (
    RuntimeConfig,
    Wave,
    WaveScheduler,
)
from repro_torch.convserve.runtime.telemetry import Telemetry, stage_rollup


class ServeRuntime:
    """One net's online serving loop over a replica pool."""

    def __init__(
        self,
        pool: ReplicaPool,
        cfg: RuntimeConfig,
        *,
        clock: Optional[Clock] = None,
        telemetry: Optional[Telemetry] = None,
        tracer=None,
        recorder=None,
    ):
        self.pool = pool
        self.cfg = cfg
        self.clock = clock or RealClock()
        self.telemetry = telemetry or Telemetry(clock=self.clock)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.recorder = recorder  # obs.FlightRecorder (optional)
        self.scheduler = WaveScheduler(pool.spec, cfg)
        self._lock = threading.Lock()
        self._done_cv = threading.Condition(self._lock)
        self._wake = threading.Event()  # set by submit(): interrupts idle
        self._outstanding = 0  # guarded-by: _lock
        self._next_rid = 0  # guarded-by: _lock
        self.results: Dict[int, np.ndarray] = {}  # guarded-by: _lock
        self.rejections: Dict[int, Rejection] = {}  # guarded-by: _lock
        self.errors: List[BaseException] = []  # guarded-by: _lock
        self._wave_observers: List = []
        # open request spans, closed when the result lands / is lost
        self._req_spans: Dict[int, int] = {}  # guarded-by: _lock
        # latest wave flow id per bucket: links wave -> stage profiling
        self._wave_flows: Dict[int, str] = {}  # guarded-by: _lock
        # in-flight wave spans, keyed by the pool future's identity
        self._wave_ctx: Dict[int, int] = {}  # guarded-by: _lock
        if self.tracer.active:
            for ex in getattr(self.pool, "executors", ()):
                attach_tracer(ex, self.tracer)

    def _first_executor(self):
        exs = getattr(self.pool, "executors", None)
        return exs[0] if exs else None

    def add_wave_observer(self, fn) -> None:
        """Register ``fn(result: WaveResult)`` to run after each wave's
        client-side bookkeeping completes.  This is the adapt loop's tap
        point: shadow duplication happens here, strictly AFTER the live
        wave's results and latency histograms are recorded, so whatever
        the observer does can never count toward client latency SLOs.
        Observer exceptions are counted (`wave_observer_errors`), never
        propagated into the serving path."""
        self._wave_observers.append(fn)

    # ------------------------------------------------------ admission

    def submit(
        self,
        image: np.ndarray,
        *,
        rid: Optional[int] = None,
        priority: int = STANDARD,
        deadline_s: Optional[float] = None,
    ) -> Optional[Rejection]:
        """Admit one request.  Returns None on success, else the
        `Rejection` (also kept in `self.rejections`) -- the runtime
        never throws at callers for overload."""
        now = self.clock.now()
        with self._lock:
            if rid is None:
                rid = self._next_rid
            self._next_rid = max(self._next_rid, rid) + 1
        req = Request(
            rid=rid,
            image=np.asarray(image),
            priority=priority,
            deadline=(now + deadline_s) if deadline_s is not None
            else float("inf"),
        )
        rej = self.scheduler.admit(req, now)
        if rej is not None:
            self.telemetry.inc("rejected")
            self.telemetry.inc(f"rejected.{rej.reason}")
            self.tracer.instant(
                "request.rejected", CAT_REQUEST, rid=rid, reason=rej.reason
            )
            with self._lock:
                self.rejections[rid] = rej
            return rej
        self.telemetry.inc("admitted")
        sid = self.tracer.begin(
            f"request:{rid}", CAT_REQUEST,
            flow_out=(f"r{rid}",), rid=rid, priority=priority,
        )
        if sid:
            with self._lock:
                self._req_spans[rid] = sid
        # a serving loop asleep until the next deadline/arrival must
        # reconsider now that this request's own deadline is in play
        self._wake.set()
        return None

    # ------------------------------------------------------- dispatch

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Compile every (bucket, batch size) program on every replica
        and prepare the shared kernel transforms before traffic.  Also
        seeds the scheduler's hysteresis, so the first deadline-flushed
        partial wave already rides a warm program.  Defaults to the one
        shape steady traffic uses: the full `max_batch` wave."""
        sizes = list(batch_sizes) if batch_sizes else [self.cfg.max_batch]
        self.pool.warmup(self.cfg.buckets, sizes)
        for b in self.cfg.buckets:
            for s in sizes:
                self.scheduler.note_compiled(b, s)

    def poll(self) -> int:
        """Dispatch ready waves (full queues first come first via
        round-robin, then expired slack) while the pool has a free
        replica slot.  Returns the number of waves dispatched.

        The capacity gate is what preserves batching under overload:
        with every replica busy, ready requests stay IN the scheduler's
        queues -- where late arrivals can still join their wave -- and
        the backlog drains as full waves instead of a convoy of
        singles queued behind a saturated pool."""
        n = 0
        while self.pool.has_capacity():
            wave = self.scheduler.next_wave(self.clock.now())
            if wave is None:
                return n
            self._dispatch(wave)
            n += 1
        return n

    def _dispatch(self, wave: Wave) -> None:
        now = self.clock.now()
        for r in wave.requests:
            r.t_dispatch = now
        with self._lock:
            self._outstanding += 1
        self.telemetry.inc("waves")
        self.telemetry.inc(f"waves.{wave.reason}")
        if wave.partial:
            self.telemetry.inc("partial_waves")
        # the wave span opens on the dispatch thread and closes on a
        # replica completion thread: explicit begin/end, id carried in
        # _wave_ctx keyed by the pool future (registered BEFORE the
        # callback so inline/already-done futures still find it)
        sid = self.tracer.begin(
            f"wave:b{wave.bucket}", CAT_WAVE,
            flow_in=tuple(f"r{r.rid}" for r in wave.requests),
            bucket=wave.bucket, n=len(wave.requests),
            reason=wave.reason, partial=wave.partial,
        )
        fut = self.pool.submit(wave)
        if sid:
            with self._lock:
                self._wave_ctx[id(fut)] = sid
        fut.add_done_callback(self._on_done)

    def _close_wave_span(self, fut, wave: Optional[Wave], **args) -> None:
        """Close the wave span opened at dispatch (and the request spans
        it carried, when the wave's outcome is known here)."""
        with self._lock:
            sid = self._wave_ctx.pop(id(fut), 0)
        if not sid:
            return
        flow = f"w{sid}"
        self.tracer.end(sid, flow_out=(flow,), **args)
        if wave is not None:
            with self._lock:
                self._wave_flows[wave.bucket] = flow

    def _on_done(self, fut) -> None:
        try:
            res: WaveResult = fut.result()
        except BaseException as e:  # keep serving; surface in stats
            self.telemetry.inc("wave_errors")
            self._close_wave_span(fut, None, error=type(e).__name__)
            self.tracer.instant("wave.error", CAT_WAVE, error=str(e)[:200])
            self._trip_on_error(e)
            with self._done_cv:
                self.errors.append(e)
                self._outstanding -= 1
                self._done_cv.notify_all()
            return
        done = self.clock.now()
        wave = res.wave
        if res.compiled:
            # cold wave: wall time carries first-use set-up + compute;
            # feeding it into the slack EWMA would zero every queue's slack and
            # degenerate scheduling into per-request waves until the
            # estimate decays.  Count it, histogram it separately.
            self.telemetry.inc("cold_waves")
            self.telemetry.observe("compute_cold", res.compute_s)
        else:
            if self.clock.realtime:
                # under a SimClock, wall-clock compute is not on the
                # simulated timeline: feeding it into the slack model
                # would make "deterministic" scheduling host-dependent,
                # so the estimate stays at cfg.service_est_s (tests set
                # it explicitly / via observe_service)
                self.scheduler.observe_service(wave.bucket, res.compute_s)
            self.telemetry.observe("compute", res.compute_s)
        self.telemetry.inc("images", len(wave.requests))
        self._close_wave_span(
            fut, wave, replica=res.replica, compute_s=res.compute_s,
            compiled=res.compiled, pid=res.replica,
        )
        misses = 0
        for r in wave.requests:
            r.t_done = done
            self.telemetry.observe("queue_wait", r.t_dispatch - r.t_admit)
            self.telemetry.observe("e2e", done - r.t_admit)
            miss = done > r.deadline
            if miss:
                self.telemetry.inc("deadline_miss")
                misses += 1
            with self._lock:
                rsid = self._req_spans.pop(r.rid, 0)
            self.tracer.end(rsid, deadline_miss=miss)
        if misses and self.recorder is not None:
            self.recorder.trip(
                "slo_breach", bucket=wave.bucket, misses=misses
            )
        with self._done_cv:
            self.results.update(res.outputs)
            self._outstanding -= 1
            self._done_cv.notify_all()
        for fn in self._wave_observers:
            try:
                fn(res)
            except Exception:
                self.telemetry.inc("wave_observer_errors")

    def _trip_on_error(self, e: BaseException) -> None:
        """Route a wave-path exception to the flight recorder when it is
        one of the dump-worthy kinds."""
        if self.recorder is None:
            return
        from repro_torch.convserve.check.diagnostics import VerificationError

        if isinstance(e, VerificationError):
            self.recorder.trip("verification_error", error=str(e)[:200])

    # ------------------------------------------------------ the loop

    def run_until(self, t_target: float) -> None:
        """Serve until the clock reaches `t_target`: dispatch ready
        waves, otherwise sleep to the next deadline flush (or the
        target).  With a SimClock this advances simulated time."""
        while True:
            self.poll()
            now = self.clock.now()
            if now >= t_target:
                return
            wake = min(self.scheduler.next_event(now), t_target)
            with self._done_cv:
                busy = self._outstanding > 0
            if busy:
                # waves in flight (threaded pool): wait on the completion
                # signal, bounded by the next scheduled instant, so a
                # freed replica dispatches the next ready wave the moment
                # it exists instead of idling until wake/t_target
                self._await_completion(
                    min(wake - now, 0.05) if wake > now else 0.005
                )
            elif wake > now:
                self._sleep_interruptible(wake - now)
            # wake == now and idle: a bucket crossed its flush instant
            # this iteration; loop and poll again

    def _sleep_interruptible(self, seconds: float) -> None:
        """Idle until `seconds` pass OR a client thread submits (which
        may move the next deadline earlier than the wake time this loop
        computed).  SimClock sleeps advance simulated time directly --
        sim tests drive submit and poll from one thread."""
        if self.clock.realtime:
            self._wake.wait(timeout=seconds)
            self._wake.clear()
        else:
            self.clock.sleep(seconds)

    def _await_completion(self, timeout: float) -> None:
        with self._done_cv:
            if self._outstanding:
                self._done_cv.wait(timeout=timeout)

    def drain(self) -> None:
        """Flush every queue (ready waves first, then forced partial
        drains, all capacity-gated) and wait for every in-flight wave
        to complete."""
        while True:
            self.poll()
            if self.pool.has_capacity() and self.scheduler.depth():
                wave = self.scheduler.drain_wave(self.clock.now())
                if wave is not None:
                    self._dispatch(wave)
                    continue
            with self._done_cv:
                if not self._outstanding and not self.scheduler.depth():
                    return
                if self._outstanding:
                    self._done_cv.wait(timeout=0.05)

    def play(
        self,
        trace: Sequence[Arrival],
        images: Dict[int, np.ndarray],
    ) -> Dict[int, np.ndarray]:
        """Replay an open-loop arrival trace (loadgen.*_trace) against
        this runtime, drain, and return the results map."""
        t0 = self.clock.now()
        for a in sorted(trace, key=lambda a: a.t):
            self.run_until(t0 + a.t)
            self.submit(
                images[a.rid], rid=a.rid,
                priority=a.priority, deadline_s=a.deadline_s,
            )
        self.drain()
        return dict(self.results)

    def pop_result(self, rid: int, default=None):
        """Consume one result (and its memory).  Long-running services
        should pop (or periodically clear `results`) -- the dict itself
        never evicts, which is fine for bounded traces but grows without
        bound under continuous traffic."""
        with self._lock:
            return self.results.pop(rid, default)

    # ---------------------------------------------------------- stats

    def stats(self, profile_bucket: Optional[int] = None) -> dict:
        """The runtime's single JSON document: latency histograms plus
        scheduler / pool / shared-cache sections (and, on request, the
        per-stage profile rollup at one bucket geometry)."""
        self.telemetry.set_gauge("queue_depth", self.scheduler.depth())
        stages = None
        roofline = None
        if profile_bucket is not None:
            with self._lock:
                fid = self._wave_flows.get(profile_bucket)
            # the flow hint links the latest wave at this bucket to the
            # stage spans the profile sweep opens
            with self.tracer.flow(fid):
                profile = self.pool.profile_stages(profile_bucket)
            stages = stage_rollup(profile)
            roofline = self._roofline_section(profile)
        trace = self.tracer.stats() if self.tracer.active else None
        return self.telemetry.snapshot(
            scheduler=self.scheduler.stats(),
            pool=self.pool.stats(),
            cache=self.pool.cache.stats(),
            stages=stages,
            roofline=roofline,
            trace=trace,
        )

    def _roofline_section(self, profile) -> Optional[dict]:
        """Join the stage profile with TileAlgebra + HardwareModel into
        the live roofline attribution (None when the pool's executors do
        not expose a program/hw pair, e.g. bare NetExecutors)."""
        ex = self._first_executor()
        program = getattr(ex, "program", None)
        hw = getattr(ex, "hw", None)
        if program is None or hw is None:
            return None
        from repro_torch.convserve.obs import roofline as roofline_mod

        dev = replica_device(ex)
        backend = None if dev is None else (
            "torch-cuda" if dev.type == "cuda" else "torch-cpu")
        return roofline_mod.roofline_section(
            program, profile, hw, batch=1, tracer=self.tracer, backend=backend
        )

    def shutdown(self) -> None:
        self.drain()
        self.pool.shutdown()
