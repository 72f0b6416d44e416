"""Elastic replica pool: a discrete-event fleet with faults and probes.

`ReplicaPool` (runtime/replicas.py) is a fixed set of executors on a
thread pool; an elastic fleet needs three things it cannot express:

  * **replica lifecycle** -- replicas are born (STARTING, compile +
    warm for `startup_s` of clock time before taking traffic), serve
    (READY), leave gracefully (DRAINING: no new waves, in-flight wave
    finishes, then RETIRED), or leave badly (FAILED on an injected
    crash, QUARANTINED when health probes catch a slow or corrupted
    replica);
  * **simulated occupancy** -- under a `SimClock`, wave outputs are
    computed by the real executors (instant in simulated time) while a
    deterministic `service model` charges the replica `service_s` of
    *simulated* busy time.  Completions are heap events; `advance(now)`
    resolves every event at or before `now`, and `next_event()` lets
    the fleet runtime step the clock exactly onto the next completion,
    replica-ready instant, fault, or probe -- so a million-user day
    runs in seconds of wall time with exact latency stamps.  Under a
    `RealClock` the pool degrades to inline execution (the thin
    threaded mode; the DES machinery books `free_at` from measured wall
    time).  Inline means one stream on the card: the caller's.  Every
    wave's output is brought to the host, which waits for the card, so
    the wall time read after it is compute time, not launch time.
  * **fault-tolerant dispatch** -- a `runtime.fault.FaultPlan` injects
    crashes, slowdowns, and shared-cache corruption on the same clock.
    A crash orphans the victim's in-flight wave; the pool re-dispatches
    it to a healthy replica with bounded retries, and when retries run
    out the wave's future resolves to a `WaveLoss` carrying a
    machine-readable reason -- every admitted request is either served
    or reason-coded lost, never silently dropped.

The pool duck-types `ReplicaPool` where `ServeRuntime` cares (`spec`,
`cache`, `clock`, `submit`, `has_capacity`, `warmup`, `profile_stages`,
`stats`, `shutdown`), so the fleet runtime is a subclass of the serving
runtime, not a fork of it.  It also offers `warm_workers`, which the
hot-swap path calls: an inline pool has no worker streams, so it warms
on the caller's.

The health probe stays bitwise, as the reference's rule is.  On the card
that holds because every replica runs the probe at the same shape with
the same plan, the same shared cache and the same launch geometry, and
the tile kernel has no atomics; and because `KernelCache.invalidate`
followed by a fresh transform rebuilds an entry bit for bit.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.convserve.fleet.sharding import ShardedWaveExecutor, probe_image
from repro_torch.convserve.obs.trace import (
    CAT_FLEET,
    NULL_TRACER,
    attach as attach_tracer,
)
from repro_torch.convserve.runtime.clock import Clock, RealClock
from repro_torch.convserve.runtime.replicas import WaveResult, _host
from repro_torch.convserve.runtime.scheduler import Wave
from repro_torch.runtime.fault import (
    FAULT_CACHE_CORRUPT,
    FAULT_CRASH,
    FAULT_SLOW,
    FaultPlan,
)

# replica lifecycle states
STARTING = "starting"
READY = "ready"
DRAINING = "draining"
RETIRED = "retired"
FAILED = "failed"
QUARANTINED = "quarantined"
LIVE_STATES = (STARTING, READY, DRAINING)

# wave-loss reasons (the dispatch analogue of the admission-reject
# vocabulary: accounting counts by it, tests assert on it)
LOSS_RETRIES_EXHAUSTED = "retries_exhausted"
LOSS_NO_HEALTHY_REPLICA = "no_healthy_replica"
LOSS_REASONS = (LOSS_RETRIES_EXHAUSTED, LOSS_NO_HEALTHY_REPLICA)


class WaveLoss(RuntimeError):
    """A wave the fleet could not serve: carries the wave and a reason
    code so the runtime can account for every admitted request."""

    def __init__(self, wave: Wave, reason: str):
        super().__init__(f"wave of {len(wave.requests)} lost: {reason}")
        self.wave = wave
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class FixedServiceModel:
    """Deterministic simulated service time for one wave.

    ``base_s + per_image_s * rows`` for the unsharded wave; sharding
    divides the row term across shards and charges a per-extra-shard
    overhead (scatter/gather), so the model rewards sharding big waves
    and penalizes sharding tiny ones -- the shape a real mesh shows.
    A slow replica multiplies the whole thing by its fault factor."""

    base_s: float = 0.004
    per_image_s: float = 0.002
    shard_overhead_s: float = 0.0005

    def service_s(self, wave: Wave, *, shards: int = 1,
                  slow_factor: float = 1.0) -> float:
        shards = max(1, min(shards, len(wave.requests)))
        rows = self.per_image_s * len(wave.requests) / shards
        over = self.shard_overhead_s * (shards - 1)
        return (self.base_s + rows + over) * slow_factor


@dataclasses.dataclass
class Replica:
    """One fleet member: an executor plus its lifecycle bookkeeping.
    All mutable fields are guarded by the owning pool's `_lock`."""

    idx: int
    executor: ShardedWaveExecutor
    state: str = STARTING
    ready_at: float = 0.0
    free_at: float = 0.0  # sim time its current wave completes
    slow_factor: float = 1.0
    dispatched: int = 0
    probes: int = 0
    probe_failures: int = 0
    retired_at: Optional[float] = None

    @property
    def live(self) -> bool:
        return self.state in LIVE_STATES


class _Completion:
    """One in-flight wave's completion record (heap events point here;
    re-dispatch after a crash swaps `replica`/`t_done` and leaves stale
    heap entries to lazy-invalidate against `epoch`)."""

    __slots__ = ("seq", "wave", "future", "replica", "t_done", "t_submit",
                 "retries", "epoch", "resolved")

    def __init__(self, seq: int, wave: Wave, future: Future,
                 replica: int, t_done: float, t_submit: float):
        self.seq = seq
        self.wave = wave
        self.future = future
        self.replica = replica
        self.t_done = t_done
        self.t_submit = t_submit
        self.retries = 0
        self.epoch = 0  # bumped on re-dispatch; heap entries carry a copy
        self.resolved = False


class ElasticPool:
    """A growable/shrinkable fleet of replicas of one compiled net,
    sharing one `KernelCache` and one plan, with injectable faults."""

    def __init__(
        self,
        replicas: Sequence[ShardedWaveExecutor],
        *,
        clock: Optional[Clock] = None,
        make_replica: Optional[Callable[[], ShardedWaveExecutor]] = None,
        service_model: Optional[FixedServiceModel] = None,
        fault_plan: Optional[FaultPlan] = None,
        max_retries: int = 2,
        startup_s: float = 5.0,
        probe_interval_s: Optional[float] = None,
        slow_quarantine_factor: float = 2.5,
        max_replicas: int = 64,
        tracer=None,
    ):
        if not replicas:
            raise ValueError("elastic pool needs at least one replica")
        cache = replicas[0].cache
        spec = replicas[0].spec
        for ex in replicas[1:]:
            if ex.cache is not cache:
                raise ValueError(
                    "fleet replicas must share one KernelCache"
                )
            if ex.spec is not spec and ex.spec != spec:
                raise ValueError("fleet replicas must serve the same NetSpec")
        self.spec = spec
        self.cache = cache
        self.clock = clock or RealClock()
        self.service_model = service_model or FixedServiceModel()
        self.fault_plan = fault_plan
        self.max_retries = max_retries
        self.startup_s = startup_s
        self.probe_interval_s = probe_interval_s
        self.slow_quarantine_factor = slow_quarantine_factor
        self.max_replicas = max_replicas
        self._make_replica = make_replica
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.active:
            for ex in replicas:
                attach_tracer(ex, self.tracer)

        now = self.clock.now()
        self._lock = threading.RLock()
        self.replicas: List[Replica] = [  # guarded-by: _lock
            Replica(idx=i, executor=ex, state=READY,
                    ready_at=now, free_at=now)
            for i, ex in enumerate(replicas)
        ]
        self._events: List[tuple] = []  # guarded-by: _lock (heap)
        self._eseq = 0  # guarded-by: _lock (heap tiebreak)
        self._inflight: Dict[int, _Completion] = {}  # guarded-by: _lock
        self._wseq = 0  # guarded-by: _lock (wave seq)
        self._warm_shapes: List[tuple] = []  # guarded-by: _lock
        self._golden: Dict[int, np.ndarray] = {}  # guarded-by: _lock
        self._next_probe_t = (  # guarded-by: _lock
            now + probe_interval_s if probe_interval_s else float("inf")
        )
        # counters -- all guarded-by: _lock
        self.dispatches = 0
        self.retries = 0
        self.orphaned = 0
        self.losses: Dict[str, int] = {}
        self.grown = 0
        self.retired = 0
        self.failures = 0
        self.quarantines = 0
        self.cache_repairs = 0
        self.probe_mismatches = 0

    # ----------------------------------------------------------- build

    @classmethod
    def build(cls, engine, spec, weights, n: int, *,
              shards: int = 1, mesh=None,
              clock: Optional[Clock] = None,
              fuse: bool = True,
              **kwargs):
        """Compile `n` sharded replicas of one net on one engine (hence
        one shared cache), planning ONCE, and keep the factory so
        `grow()` can mint identical replicas later.  Extra engine
        compile knobs (e.g. ``input_hw``) ride through `compile_kwargs`.
        """
        compile_kwargs = {
            k: kwargs.pop(k)
            for k in ("input_hw", "verify") if k in kwargs
        }
        first = engine.compile(spec, weights, fuse=fuse, **compile_kwargs)

        def make():
            net = engine.compile(
                spec, weights, plan=first.plan, fuse=fuse, **compile_kwargs
            )
            return ShardedWaveExecutor(net, shards=shards, mesh=mesh)

        execs = [ShardedWaveExecutor(first, shards=shards, mesh=mesh)]
        execs += [make() for _ in range(n - 1)]
        return cls(execs, clock=clock, make_replica=make, **kwargs)

    # ------------------------------------------------------- lifecycle

    def grow(self, n: int = 1, *, now: Optional[float] = None) -> List[int]:
        """Add `n` STARTING replicas (compiled + warmed immediately in
        wall time; taking traffic only after `startup_s` of clock time,
        which models image pull + process boot on a real fleet).
        Returns the new replica indices."""
        if self._make_replica is None:
            raise ValueError("pool built without a replica factory")
        t = self.clock.now() if now is None else now
        born: List[int] = []
        for _ in range(n):
            with self._lock:
                if sum(r.live for r in self.replicas) >= self.max_replicas:
                    break
            ex = self._make_replica()  # compile outside the lock
            self._warm_executor(ex)
            if self.tracer.active:
                attach_tracer(ex, self.tracer)
            with self._lock:
                idx = len(self.replicas)
                ready = t + self.startup_s
                self.replicas.append(Replica(
                    idx=idx, executor=ex, state=STARTING,
                    ready_at=ready, free_at=ready,
                ))
                heapq.heappush(
                    self._events, (ready, self._eseq, "ready", idx)
                )
                self._eseq += 1
                self.grown += 1
                born.append(idx)
            self.tracer.instant(
                "fleet.grow", CAT_FLEET, pid=idx, replica=idx, ready_at=ready
            )
        return born

    def retire(self, n: int = 1, *, now: Optional[float] = None) -> List[int]:
        """Mark `n` replicas DRAINING (newest READY first; STARTING ones
        are cancelled outright).  A draining replica takes no new waves;
        its in-flight wave completes, then it is RETIRED -- `advance`
        performs the hand-off.  Never drains the last live replica."""
        t = self.clock.now() if now is None else now
        out: List[int] = []
        with self._lock:
            for _ in range(n):
                live = [r for r in self.replicas if r.live]
                if len(live) <= 1:
                    break
                victims = [r for r in live if r.state == STARTING]
                if not victims:
                    victims = [r for r in live if r.state == READY]
                if not victims:
                    break
                r = victims[-1]  # newest first: LIFO keeps the fleet warm
                if r.state == STARTING:
                    r.state = RETIRED
                    r.retired_at = t
                else:
                    r.state = DRAINING
                    if r.free_at <= t:  # idle: retires immediately
                        r.state = RETIRED
                        r.retired_at = t
                    else:
                        heapq.heappush(
                            self._events,
                            (r.free_at, self._eseq, "drain", r.idx),
                        )
                        self._eseq += 1
                self.retired += 1
                out.append(r.idx)
        for idx in out:
            self.tracer.instant(
                "fleet.retire", CAT_FLEET, pid=idx, replica=idx
            )
        return out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for r in self.replicas:
                out[r.state] = out.get(r.state, 0) + 1
            return out

    def ready_count(self) -> int:
        with self._lock:
            return sum(r.state == READY for r in self.replicas)

    def live_count(self) -> int:
        with self._lock:
            return sum(r.live for r in self.replicas)

    @property
    def executors(self) -> List[ShardedWaveExecutor]:
        with self._lock:
            return [r.executor for r in self.replicas if r.live]

    # -------------------------------------------------------- dispatch

    def has_capacity(self) -> bool:
        """A wave dispatched now starts now: some READY replica is idle
        at the current clock reading."""
        now = self.clock.now()
        with self._lock:
            return any(
                r.state == READY and r.free_at <= now for r in self.replicas
            )

    def _pick_locked(self, now: float) -> Optional[Replica]:
        # holds-lock: _lock
        ready = [r for r in self.replicas if r.state == READY]
        if not ready:
            return None
        return min(ready, key=lambda r: (max(r.free_at, now),
                                         r.dispatched, r.idx))

    def submit(self, wave: Wave) -> "Future[WaveResult]":
        """Schedule the wave on the best READY replica.  Under a
        SimClock the future resolves when `advance` reaches the
        completion instant; under a RealClock it resolves inline."""
        now = self.clock.now()
        fut: Future = Future()
        with self._lock:
            r = self._pick_locked(now)
            if r is None:
                self.losses[LOSS_NO_HEALTHY_REPLICA] = (
                    self.losses.get(LOSS_NO_HEALTHY_REPLICA, 0) + 1
                )
                self.tracer.instant(
                    "fleet.wave_lost", CAT_FLEET,
                    reason=LOSS_NO_HEALTHY_REPLICA, n=len(wave.requests),
                )
                fut.set_exception(WaveLoss(wave, LOSS_NO_HEALTHY_REPLICA))
                return fut
            service = self.service_model.service_s(
                wave, shards=r.executor.shards, slow_factor=r.slow_factor
            )
            t_start = max(r.free_at, now)
            t_done = t_start + service
            r.free_at = t_done
            r.dispatched += 1
            self.dispatches += 1
            seq = self._wseq
            self._wseq += 1
            rec = _Completion(seq, wave, fut, r.idx, t_done, now)
            self._inflight[seq] = rec
            heapq.heappush(
                self._events, (t_done, self._eseq, "complete", (seq, 0))
            )
            self._eseq += 1
        if self.clock.realtime:
            # thin threaded mode: compute inline on the caller's thread
            # (the fleet's determinism story lives on the SimClock path)
            self.advance(float("inf"))
        return fut

    def _execute(self, rec: _Completion, replica: Replica) -> WaveResult:
        """Run the wave's actual computation (at completion time, so a
        crash beforehand orphans un-computed work cleanly)."""
        ex = replica.executor
        batch, sizes = rec.wave.assemble()
        before = ex.compile_count
        t0 = self.clock.now()
        # the host copy waits for the card: `wall` is read after it
        y = _host(ex(batch, sizes))
        wall = self.clock.now() - t0
        compute = wall if self.clock.realtime else rec.t_done - rec.t_submit
        return WaveResult(
            wave=rec.wave, outputs=rec.wave.crop(self.spec, y),
            replica=replica.idx, compute_s=compute,
            compiled=ex.compile_count > before,
        )

    # ------------------------------------------------------ simulation

    def next_event(self) -> float:
        """Clock time of the next pool event: a completion, a replica
        becoming ready / finishing its drain, a scheduled fault, or a
        health probe.  inf when the pool is quiescent."""
        with self._lock:
            t = self._events[0][0] if self._events else float("inf")
            t = min(t, self._next_probe_t)
        if self.fault_plan is not None:
            t = min(t, self.fault_plan.next_t())
        return t

    def advance(self, now: float) -> int:
        """Resolve every event at or before `now` in TIME order --
        completions, replica transitions, faults, and probes interleave
        on one timeline, so a crash at t=5 can never orphan a wave that
        completed at t=3 just because both fell inside one step.
        Returns the number of completions resolved.  This is the DES
        heart: the fleet runtime calls it each loop iteration after
        stepping the clock.  (``advance(inf)`` -- shutdown / the inline
        realtime path -- flushes events and faults but not the periodic
        probes, which would never terminate.)"""
        done = 0
        inf = float("inf")
        while True:
            with self._lock:
                t_ev = self._events[0][0] if self._events else inf
                # periodic probes only tick toward a finite horizon
                t_pr = self._next_probe_t if math.isfinite(now) else inf
            t_fl = self.fault_plan.next_t() if self.fault_plan else inf
            t = min(t_ev, t_pr, t_fl)
            if t > now or t == inf:
                return done
            if t_ev == t:
                # heap events at this instant resolve before a fault at
                # the same instant: the wave made it
                ripe: List[tuple] = []
                with self._lock:
                    while self._events and self._events[0][0] <= t:
                        ripe.append(heapq.heappop(self._events))
                for tt, _, kind, payload in ripe:
                    if kind == "ready":
                        self._on_ready(payload)
                    elif kind == "drain":
                        self._on_drain(payload, tt)
                    elif kind == "complete":
                        done += self._on_complete(payload)
                continue
            if t_fl == t:
                for fault in self.fault_plan.due(t):
                    self._apply_fault(fault, t)
                continue
            with self._lock:
                self._next_probe_t += self.probe_interval_s
            self.probe(t)

    def _on_ready(self, idx: int) -> None:
        with self._lock:
            r = self.replicas[idx]
            became_ready = r.state == STARTING
            if became_ready:
                r.state = READY
        if became_ready:
            self.tracer.instant(
                "fleet.ready", CAT_FLEET, pid=idx, replica=idx
            )

    def _on_drain(self, idx: int, t: float) -> None:
        with self._lock:
            r = self.replicas[idx]
            if r.state == DRAINING and r.free_at <= t:
                r.state = RETIRED
                r.retired_at = t

    def _on_complete(self, payload) -> int:
        seq, epoch = payload
        with self._lock:
            rec = self._inflight.get(seq)
            if rec is None or rec.resolved or rec.epoch != epoch:
                return 0  # stale heap entry (re-dispatched or lost)
            replica = self.replicas[rec.replica]
            rec.resolved = True
            del self._inflight[seq]
        # the actual compute happens OUTSIDE the lock: it is the
        # expensive part, and it only touches the executor + the
        # internally-locked shared cache
        try:
            res = self._execute(rec, replica)
            rec.future.set_result(res)
        except BaseException as e:
            rec.future.set_exception(e)
        return 1

    # ---------------------------------------------------------- faults

    def _apply_fault(self, fault, now: float) -> None:
        self.tracer.instant(
            "fleet.fault", CAT_FLEET, pid=getattr(fault, "replica", 0) or 0,
            kind=fault.kind, replica=getattr(fault, "replica", None),
        )
        if fault.kind == FAULT_CACHE_CORRUPT:
            self.cache.corrupt_entry()
            return
        with self._lock:
            if fault.replica >= len(self.replicas):
                return
            r = self.replicas[fault.replica]
            if fault.kind == FAULT_SLOW:
                if r.live:
                    r.slow_factor = fault.factor
                return
            # FAULT_CRASH: the replica dies NOW; any in-flight wave on
            # it is orphaned and re-dispatched with bounded retries
            if fault.kind != FAULT_CRASH or not r.live:
                return
            r.state = FAILED
            r.retired_at = now
            self.failures += 1
            orphans = [
                rec for rec in self._inflight.values()
                if rec.replica == r.idx and not rec.resolved
            ]
            for rec in orphans:
                self.orphaned += 1
                self._redispatch_locked(rec, now)

    def _redispatch_locked(self, rec: _Completion, now: float) -> None:
        # holds-lock: _lock
        rec.retries += 1
        rec.epoch += 1
        if rec.retries > self.max_retries:
            self._lose_locked(rec, LOSS_RETRIES_EXHAUSTED)
            return
        r = self._pick_locked(now)
        if r is None:
            self._lose_locked(rec, LOSS_NO_HEALTHY_REPLICA)
            return
        self.retries += 1
        self.tracer.instant(
            "fleet.redispatch", CAT_FLEET, pid=r.idx,
            replica=r.idx, retries=rec.retries,
            n=len(rec.wave.requests),
        )
        service = self.service_model.service_s(
            rec.wave, shards=r.executor.shards, slow_factor=r.slow_factor
        )
        rec.replica = r.idx
        rec.t_done = max(r.free_at, now) + service
        r.free_at = rec.t_done
        r.dispatched += 1
        heapq.heappush(
            self._events,
            (rec.t_done, self._eseq, "complete", (rec.seq, rec.epoch)),
        )
        self._eseq += 1

    def _lose_locked(self, rec: _Completion, reason: str) -> None:
        # holds-lock: _lock
        rec.resolved = True
        self._inflight.pop(rec.seq, None)
        self.losses[reason] = self.losses.get(reason, 0) + 1
        self.tracer.instant(
            "fleet.wave_lost", CAT_FLEET, reason=reason,
            n=len(rec.wave.requests),
        )
        rec.future.set_exception(WaveLoss(rec.wave, reason))

    # ---------------------------------------------------------- health

    def _warm_executor(self, ex) -> None:
        with self._lock:
            shapes = list(self._warm_shapes)
        for b, s, c0 in shapes:
            x = np.zeros((s, b, b, c0), np.float32)
            _host(ex(x, np.zeros((s, 2), np.int32)))

    def warmup(self, buckets: Sequence[int],
               batch_sizes: Sequence[int]) -> None:
        """Compile every (bucket, batch) program on every live replica,
        remember the shapes (grow() warms newcomers to the same set),
        and record the golden probe outputs the health probes compare
        against."""
        c0 = self.spec.conv_layers()[0][1].c_in
        with self._lock:
            for b in buckets:
                for s in batch_sizes:
                    shape = (int(b), int(s), c0)
                    if shape not in self._warm_shapes:
                        self._warm_shapes.append(shape)
            live = [r.executor for r in self.replicas if r.live]
        for ex in live:
            self._warm_executor(ex)
        self._record_golden()

    def warm_workers(self, executors: Sequence, waves: Sequence) -> None:
        """Run `waves` ((batch, sizes) pairs) once through every executor
        in `executors` -- the hot-swap path's warm-up of a candidate
        program.  The pool executes inline, so its only stream is the
        caller's: the waves run there, and each output's copy to the host
        waits for the card before the swap can flip dispatch."""
        for ex in executors:
            for x, sizes in waves:
                _host(ex(x, sizes))

    def _probe_batch(self, side: int) -> tuple:
        with self._lock:
            sizes = sorted(s for b, s, _ in self._warm_shapes if b == side)
        n = sizes[0] if sizes else 1
        c0 = self.spec.conv_layers()[0][1].c_in
        img = probe_image(self.spec, side)
        x = np.zeros((n, side, side, c0), np.float32)
        x[0] = img
        ext = np.zeros((n, 2), np.int32)
        ext[0] = (side, side)
        return x, ext

    def _record_golden(self) -> None:
        """Golden probe outputs, one per warmed bucket, from replica 0
        right after warmup -- the fleet's known-good reference."""
        with self._lock:
            buckets = sorted({b for b, _, _ in self._warm_shapes})
            ex = next(
                (r.executor for r in self.replicas if r.live), None
            )
        if ex is None:
            return
        for b in buckets:
            x, ext = self._probe_batch(b)
            y = _host(ex(x, ext))
            with self._lock:
                self._golden[b] = y[0].copy()

    def probe(self, now: Optional[float] = None) -> dict:
        """Health-probe every READY replica: run the fixed probe input
        and compare against the golden output; check the slow-factor
        against the quarantine threshold.

          * one replica mismatches -> quarantine it (bad local state);
          * EVERY probed replica mismatches -> the shared kernel cache
            is corrupted (they share nothing else): invalidate it (next
            fetch re-transforms from pristine weights) and count a
            repair -- the probe-visible recovery path for the
            ``cache_corrupt`` fault;
          * slow_factor >= threshold -> quarantine (the straggler that
            would otherwise stretch every wave it touches).
        """
        t = self.clock.now() if now is None else now
        with self._lock:
            targets = [r for r in self.replicas if r.state == READY]
            golden = dict(self._golden)
        if not targets or not golden:
            return {"probed": 0}
        side = sorted(golden)[0]
        x, ext = self._probe_batch(side)
        mismatched: List[Replica] = []
        for r in targets:
            y = _host(r.executor(x, ext))
            ok = np.array_equal(y[0], golden[side])  # bitwise, by rule
            with self._lock:
                r.probes += 1
                if not ok:
                    r.probe_failures += 1
                    self.probe_mismatches += 1
            if not ok:
                mismatched.append(r)
        repaired = False
        if mismatched and len(mismatched) == len(targets):
            # unanimous corruption: the only shared state is the cache
            self.cache.invalidate()
            with self._lock:
                self.cache_repairs += 1
            self.tracer.instant(
                "fleet.cache_repair", CAT_FLEET, probed=len(targets)
            )
            repaired = True
            mismatched = []
        with self._lock:
            for r in mismatched:
                if r.state == READY:
                    r.state = QUARANTINED
                    r.retired_at = t
                    self.quarantines += 1
                    self.tracer.instant(
                        "fleet.quarantine", CAT_FLEET, pid=r.idx,
                        replica=r.idx, why="probe_mismatch",
                    )
            slow = [
                r for r in targets
                if r.state == READY
                and r.slow_factor >= self.slow_quarantine_factor
            ]
            for r in slow:
                r.state = QUARANTINED
                r.retired_at = t
                self.quarantines += 1
                self.tracer.instant(
                    "fleet.quarantine", CAT_FLEET, pid=r.idx,
                    replica=r.idx, why="slow",
                )
            # quarantined replicas orphan their in-flight waves too
            quarantined = {r.idx for r in slow} | {
                r.idx for r in mismatched
            }
            for rec in list(self._inflight.values()):
                if rec.replica in quarantined and not rec.resolved:
                    self.orphaned += 1
                    self._redispatch_locked(rec, t)
        return {
            "probed": len(targets),
            "quarantined": len(mismatched) + len(slow),
            "cache_repaired": repaired,
        }

    # ----------------------------------------------------------- stats

    def profile_stages(self, side: int, batch: int = 1) -> List[tuple]:
        c0 = self.spec.conv_layers()[0][1].c_in
        x = np.zeros((batch, side, side, c0), np.float32)
        with self._lock:
            ex = next(r.executor for r in self.replicas if r.live)
        return ex.profile_stages(x)

    def stats(self) -> dict:
        with self._lock:
            states = {}
            for r in self.replicas:
                states[r.state] = states.get(r.state, 0) + 1
            per_replica = [
                {
                    "idx": r.idx, "state": r.state,
                    "dispatched": r.dispatched,
                    "slow_factor": r.slow_factor,
                    "probes": r.probes,
                    "probe_failures": r.probe_failures,
                }
                for r in self.replicas
            ]
            doc = {
                "replicas": len(self.replicas),
                "states": states,
                "dispatches": self.dispatches,
                "retries": self.retries,
                "orphaned": self.orphaned,
                "losses": dict(self.losses),
                "grown": self.grown,
                "retired": self.retired,
                "failures": self.failures,
                "quarantines": self.quarantines,
                "cache_repairs": self.cache_repairs,
                "probe_mismatches": self.probe_mismatches,
                "in_flight": len(self._inflight),
                "per_replica": per_replica,
                "compiled_programs": sum(
                    r.executor.compile_count for r in self.replicas
                ),
                "cache": self.cache.stats(),
            }
        if self.fault_plan is not None:
            doc["faults"] = self.fault_plan.stats()
        return doc

    def shutdown(self) -> None:
        """Resolve everything still in flight (the DES pool owns no
        threads, so shutdown is bookkeeping, not joining)."""
        self.advance(float("inf"))
