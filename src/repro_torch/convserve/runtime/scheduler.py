"""Deadline/SLO-aware wave formation over bucketed request queues.

The paper's fused path wins by amortizing pre-transformed kernels and
compiled programs across batches, so the scheduler's job is to form the
*largest wave it can afford to wait for*:

  * a bucket whose queue reaches `max_batch` dispatches a full wave
    immediately;
  * otherwise the wave waits -- but only until the oldest queued
    request's slack runs out.  Slack is measured against the request's
    completion deadline minus the bucket's (EWMA-estimated) service
    time, so a partial wave leaves the moment waiting any longer would
    break the SLO, not when a timer guesses;
  * partial waves are padded with batch-size *hysteresis*: a wave of n
    rides the smallest already-dispatched power-of-two batch >= n when
    one exists, so deadline flushes reuse already-compiled programs
    instead of minting new batch shapes under load;
  * buckets take turns: among ready buckets the scheduler rotates
    round-robin from the last bucket served, so continuous traffic in
    one bucket cannot starve another (and any queued bucket becomes
    ready once its slack expires).

The scheduler is pure logic over an injected notion of "now" -- no
threads, no sleeping -- which is what makes its behaviour provable under
a `SimClock` and shareable between the online runtime (`service.py`)
and the offline `ConvServer` front-end (which admits everything up
front and drains).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Set, Union

import numpy as np

from repro_torch.convserve.graph import NetSpec
from repro_torch.convserve.runtime.queueing import (
    BucketQueue,
    REJECT_BAD_SHAPE,
    REJECT_QUEUE_FULL,
    REJECT_TOO_LARGE,
    Rejection,
    Request,
)

# wave-dispatch reasons (telemetry vocabulary)
FLUSH_FULL = "full"
FLUSH_DEADLINE = "deadline"
FLUSH_DRAIN = "drain"


@dataclasses.dataclass
class RuntimeConfig:
    """Knobs for the serving runtime (the online superset of the offline
    `ConvServeConfig`).

    slo_s: default completion SLO per priority class (or one scalar for
    all classes); a request with no explicit deadline gets
    ``t_admit + slo``.  None means no implicit deadlines -- only full
    waves and explicit drains dispatch.
    service_est_s: initial per-wave compute estimate used for deadline
    slack before any wave has been measured (the runtime feeds measured
    wave times back via `observe_service`).
    """

    max_batch: int = 8
    buckets: Sequence[int] = (32, 64, 128, 224)
    pad_batch: bool = True  # power-of-two padding + hysteresis
    queue_depth: int = 64  # per-bucket admission bound
    slo_s: Union[None, float, Mapping[int, float]] = None
    service_est_s: float = 0.0
    service_ewma: float = 0.3  # weight of the newest wave measurement

    def slo_for(self, priority: int) -> float:
        if self.slo_s is None:
            return math.inf
        if isinstance(self.slo_s, Mapping):
            return self.slo_s.get(priority, math.inf)
        return float(self.slo_s)


@dataclasses.dataclass
class Wave:
    """One dispatchable batch: like-bucketed requests plus the padded
    batch size the executor will see."""

    bucket: int
    requests: List[Request]
    batch_size: int
    reason: str  # FLUSH_FULL | FLUSH_DEADLINE | FLUSH_DRAIN
    formed_at: float

    @property
    def partial(self) -> bool:
        return self.reason != FLUSH_FULL

    def assemble(self) -> tuple:
        """(batch, sizes): requests zero-padded into the bucket square
        and stacked; padding rows (ragged margins AND batch-fill rows)
        carry extent 0 so the executor's masking keeps serving exact."""
        c = self.requests[0].image.shape[2]
        batch = np.zeros(
            (self.batch_size, self.bucket, self.bucket, c),
            self.requests[0].image.dtype,
        )
        sizes = np.zeros((self.batch_size, 2), np.int32)
        for i, r in enumerate(self.requests):
            h, w, rc = r.image.shape
            if rc != c:
                raise ValueError(
                    f"request {r.rid}: channel mismatch {rc} != {c}"
                )
            batch[i, :h, :w, :] = r.image
            sizes[i] = (h, w)
        return batch, sizes

    def crop(self, spec: NetSpec, y: np.ndarray) -> Dict[int, np.ndarray]:
        """Per-request true-extent crops of the wave output.  Copies,
        not views: a view would pin the wave's whole padded batch buffer
        alive for as long as any single request's result is retained."""
        out: Dict[int, np.ndarray] = {}
        for i, r in enumerate(self.requests):
            h, w, c = r.image.shape
            oh, ow, _ = spec.out_shape(h, w, c)
            out[r.rid] = np.ascontiguousarray(y[i, :oh, :ow, :])
        return out


class WaveScheduler:
    """Admission + wave formation for one net's bucketed traffic."""

    def __init__(self, spec: NetSpec, cfg: RuntimeConfig):
        convs = spec.conv_layers()
        if not convs:
            raise ValueError(f"net {spec.name!r} has no conv layers")
        self._c0 = convs[0][1].c_in
        # every bucket must survive the net's whole downsampling chain;
        # simulate the exact shape pipeline (stride-2 convs halve extents
        # before pools ever see them, so a pool-factor modulo check is
        # not enough)
        for b in cfg.buckets:
            try:
                spec.infer_shapes(b, b, self._c0)
            except ValueError as e:
                raise ValueError(
                    f"bucket {b} does not survive net {spec.name!r}'s "
                    f"downsampling chain (total factor "
                    f"{spec.downsample_factor}): {e}"
                ) from None
        self.spec = spec
        self.cfg = cfg
        # one lock over queues + counters: submits arrive from client
        # threads, waves form on the runtime loop, and service-time
        # observations land on replica completion threads.  Guarding
        # admission keeps the "reject, never throw" contract under
        # concurrency (an unguarded depth check would race into
        # BucketQueue's OverflowError).
        self._lock = threading.RLock()
        self._queues: Dict[int, BucketQueue] = {  # guarded-by: _lock
            b: BucketQueue(b, cfg.queue_depth) for b in sorted(cfg.buckets)
        }
        self._order = sorted(cfg.buckets)
        self._rr = 0  # guarded-by: _lock (index of last bucket served)
        self._sizes: Dict[int, Set[int]] = {  # guarded-by: _lock
            b: set() for b in self._order
        }
        self.service_est: Dict[int, float] = {  # guarded-by: _lock
            b: cfg.service_est_s for b in self._order
        }
        self.admitted = 0  # guarded-by: _lock
        self.rejected: Dict[str, int] = {}  # guarded-by: _lock
        self.cleared = 0  # guarded-by: _lock
        self.waves = 0  # guarded-by: _lock
        self.partial_waves = 0  # guarded-by: _lock
        self.waves_by_reason: Dict[str, int] = {}  # guarded-by: _lock

    # ------------------------------------------------------- admission

    def bucket_for(self, h: int, w: int) -> Optional[int]:
        for b in self._order:
            if h <= b and w <= b:
                return b
        return None

    def admit(self, req: Request, now: float) -> Optional[Rejection]:
        """Validate + enqueue; returns a `Rejection` (never raises) when
        the request cannot be taken, so overload shows up as an explicit
        per-reason counter instead of an exception mid-wave."""
        if req.image.ndim != 3:
            return self._reject(
                req, REJECT_BAD_SHAPE, f"expected HWC, got {req.image.shape}"
            )
        h, w, c = req.image.shape
        try:
            # a bad request must fail here, not at crop time after its
            # wave-mates have already been computed
            self.spec.infer_shapes(h, w, c)
        except ValueError as e:
            return self._reject(req, REJECT_BAD_SHAPE, str(e))
        bucket = self.bucket_for(h, w)
        if bucket is None:
            return self._reject(
                req,
                REJECT_TOO_LARGE,
                f"image ({h}, {w}) exceeds largest bucket {self._order[-1]}",
            )
        with self._lock:
            q = self._queues[bucket]
            if q.full:
                return self._reject(
                    req,
                    REJECT_QUEUE_FULL,
                    f"bucket {bucket} queue at depth bound {q.depth}",
                )
            req.bucket = bucket
            req.t_admit = now
            if math.isinf(req.deadline):
                req.deadline = now + self.cfg.slo_for(req.priority)
            q.push(req)
            self.admitted += 1
        return None

    def _reject(self, req: Request, reason: str, detail: str) -> Rejection:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1
        return Rejection(rid=req.rid, reason=reason, detail=detail)

    # -------------------------------------------------- wave formation

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def depth_by_bucket(self) -> Dict[int, int]:
        with self._lock:
            return {b: len(q) for b, q in self._queues.items() if len(q)}

    def _flush_at(self, bucket: int) -> float:
        """Absolute time the bucket's oldest deadline forces a dispatch:
        completion deadline minus the estimated wave service time."""
        return self._queues[bucket].oldest_deadline() - self.service_est[
            bucket
        ]

    def _ready_reason(self, bucket: int, now: float) -> Optional[str]:
        q = self._queues[bucket]
        if not len(q):
            return None
        if len(q) >= self.cfg.max_batch:
            return FLUSH_FULL
        if now >= self._flush_at(bucket):
            return FLUSH_DEADLINE
        return None

    def next_wave(self, now: float) -> Optional[Wave]:
        """The next dispatchable wave, or None if every bucket should
        keep waiting.  Among ready buckets, rotates round-robin from the
        last bucket served -- continuous full-wave traffic in one bucket
        cannot starve another that became ready."""
        n = len(self._order)
        with self._lock:
            for step in range(1, n + 1):
                i = (self._rr + step) % n
                reason = self._ready_reason(self._order[i], now)
                if reason is not None:
                    self._rr = i
                    return self._form(self._order[i], reason, now)
        return None

    def drain_wave(self, now: float = 0.0) -> Optional[Wave]:
        """Force-form a wave from any non-empty bucket (round-robin) --
        the offline path and end-of-trace flush."""
        n = len(self._order)
        with self._lock:
            for step in range(1, n + 1):
                i = (self._rr + step) % n
                b = self._order[i]
                if len(self._queues[b]):
                    self._rr = i
                    reason = (
                        FLUSH_FULL
                        if len(self._queues[b]) >= self.cfg.max_batch
                        else FLUSH_DRAIN
                    )
                    return self._form(b, reason, now)
        return None

    def next_event(self, now: float) -> float:
        """Earliest future instant a queued bucket becomes deadline-ready
        (absolute clock time; inf when nothing is waiting on a deadline).
        The runtime sleeps until min(next arrival, this)."""
        t = math.inf
        with self._lock:
            for b in self._order:
                if len(self._queues[b]):
                    t = min(t, self._flush_at(b))
        return max(t, now)

    def _wave_size(self, bucket: int, n: int) -> int:
        if not self.cfg.pad_batch:
            return n
        p = 1
        while p < n:
            p *= 2
        p = min(p, self.cfg.max_batch)
        # hysteresis: prefer the smallest batch shape this bucket has
        # already dispatched (hence compiled) that still fits, so a
        # deadline-flushed partial wave never mints a new program when a
        # warm one can serve it
        compiled = self._sizes[bucket]
        if p not in compiled:
            bigger = [s for s in compiled if n <= s <= self.cfg.max_batch]
            if bigger:
                p = min(bigger)
        return p

    def _form(self, bucket: int, reason: str, now: float) -> Wave:
        # holds-lock: _lock (only called from poll()'s locked section)
        reqs = self._queues[bucket].pop(self.cfg.max_batch)
        size = self._wave_size(bucket, len(reqs))
        self._sizes[bucket].add(size)
        self.waves += 1
        self.waves_by_reason[reason] = self.waves_by_reason.get(reason, 0) + 1
        if reason != FLUSH_FULL:
            self.partial_waves += 1
        return Wave(
            bucket=bucket,
            requests=reqs,
            batch_size=size,
            reason=reason,
            formed_at=now,
        )

    def clear(self) -> int:
        """Drop every queued request (counted in `cleared`) -- the
        abort path: an offline batch that failed admission must not
        leak its already-admitted mates into the next run."""
        with self._lock:
            n = sum(len(q) for q in self._queues.values())
            for b in self._order:
                self._queues[b] = BucketQueue(b, self.cfg.queue_depth)
            self.cleared += n
            return n

    def note_compiled(self, bucket: int, size: int) -> None:
        """Register an externally warmed batch shape (`ReplicaPool.
        warmup`) so hysteresis pads partial waves onto it from the
        first dispatch."""
        with self._lock:
            if bucket in self._sizes:
                self._sizes[bucket].add(size)

    def compiled_sizes(self) -> Dict[int, list]:
        """Snapshot of every batch shape each bucket has dispatched (or
        had warmed): ``{bucket: sorted sizes}``.  The hot-swap path warms
        a candidate program at exactly these shapes, so the swapped-in
        replicas never cold-compile under live traffic."""
        with self._lock:
            return {b: sorted(s) for b, s in self._sizes.items()}

    def observe_service(self, bucket: int, seconds: float) -> None:
        """Feed a measured wave compute time back into the slack model."""
        a = self.cfg.service_ewma
        with self._lock:
            prev = self.service_est[bucket]
            self.service_est[bucket] = (
                seconds if prev == 0.0 else (1 - a) * prev + a * seconds
            )

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        return {
            "admitted": self.admitted,
            "rejected": dict(self.rejected),
            "cleared": self.cleared,
            "waves": self.waves,
            "partial_waves": self.partial_waves,
            "waves_by_reason": dict(self.waves_by_reason),
            "queue_depth": sum(len(q) for q in self._queues.values()),
            "queue_depth_by_bucket": {
                b: len(q) for b, q in self._queues.items() if len(q)
            },
            "service_est_s": dict(self.service_est),
        }
