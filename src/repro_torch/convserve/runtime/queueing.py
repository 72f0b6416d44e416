"""Bounded per-bucket request queues with priority classes and
admission control.

A `Request` is one image plus its scheduling metadata (priority class,
absolute completion deadline).  Admission either stamps it into exactly
one spatial bucket's `BucketQueue` or returns a `Rejection` carrying a
machine-readable reason -- overload is an explicit, observable outcome,
never an unbounded queue.  Within a bucket, requests pop in (priority
class, FIFO) order; fairness *across* buckets is the scheduler's job
(round-robin in `scheduler.WaveScheduler`).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List

import numpy as np

# priority classes: lower is more urgent
INTERACTIVE = 0
STANDARD = 1
BATCH = 2

# admission-reject reasons (the closed vocabulary telemetry counts by);
# "scaling" is the fleet runtime's scale-up admission gate: while new
# replicas warm, the queue is capped at what the READY ones can drain
REJECT_QUEUE_FULL = "queue_full"
REJECT_TOO_LARGE = "too_large"
REJECT_BAD_SHAPE = "bad_shape"
REJECT_SCALING = "scaling"
REJECT_REASONS = (
    REJECT_QUEUE_FULL, REJECT_TOO_LARGE, REJECT_BAD_SHAPE, REJECT_SCALING,
)


@dataclasses.dataclass
class Request:
    """One in-flight image request.  `deadline` is the absolute clock
    time the response should be *completed* by (inf = no deadline; the
    scheduler assigns one from the priority class's SLO when unset).
    Admission fills `bucket`/`t_admit`; dispatch and completion stamp
    the remaining times for the latency histograms."""

    rid: int
    image: np.ndarray  # (H, W, C)
    priority: int = STANDARD
    deadline: float = math.inf
    # stamped by the runtime:
    bucket: int = -1
    t_admit: float = math.nan
    t_dispatch: float = math.nan
    t_done: float = math.nan


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Why a request was not admitted."""

    rid: int
    reason: str  # one of REJECT_REASONS
    detail: str = ""


class BucketQueue:
    """One spatial bucket's pending requests: a bounded deque per
    priority class, popped urgent-first and FIFO within a class."""

    def __init__(self, bucket: int, depth: int):
        self.bucket = bucket
        self.depth = depth
        self._q: Dict[int, Deque[Request]] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    @property
    def full(self) -> bool:
        return len(self) >= self.depth

    def push(self, req: Request) -> None:
        if self.full:
            raise OverflowError(
                f"bucket {self.bucket} queue at depth bound {self.depth}"
            )
        self._q.setdefault(req.priority, deque()).append(req)

    def pop(self, n: int) -> List[Request]:
        """Up to `n` requests, most-urgent class first, FIFO within."""
        out: List[Request] = []
        for pri in sorted(self._q):
            q = self._q[pri]
            while q and len(out) < n:
                out.append(q.popleft())
            if len(out) == n:
                break
        return out

    def oldest_deadline(self) -> float:
        """Earliest completion deadline among queued requests (inf when
        empty or none carry a deadline) -- what forces the scheduler's flushes."""
        return min(
            (r.deadline for q in self._q.values() for r in q),
            default=math.inf,
        )
