"""Serving-runtime pieces the offline `ConvServer` runs on: the
injectable `Clock`, bounded per-bucket queues with admission control,
and the deadline-aware `WaveScheduler`.  The online loop (replicas,
service, telemetry, load generation) is not ported yet."""

from repro_torch.convserve.runtime.clock import Clock, RealClock, SimClock
from repro_torch.convserve.runtime.queueing import (
    BATCH,
    INTERACTIVE,
    REJECT_BAD_SHAPE,
    REJECT_QUEUE_FULL,
    REJECT_REASONS,
    REJECT_SCALING,
    REJECT_TOO_LARGE,
    STANDARD,
    BucketQueue,
    Rejection,
    Request,
)
from repro_torch.convserve.runtime.scheduler import (
    FLUSH_DEADLINE,
    FLUSH_DRAIN,
    FLUSH_FULL,
    RuntimeConfig,
    Wave,
    WaveScheduler,
)

__all__ = [
    "Clock",
    "RealClock",
    "SimClock",
    "Request",
    "Rejection",
    "BucketQueue",
    "INTERACTIVE",
    "STANDARD",
    "BATCH",
    "REJECT_REASONS",
    "REJECT_QUEUE_FULL",
    "REJECT_TOO_LARGE",
    "REJECT_BAD_SHAPE",
    "REJECT_SCALING",
    "RuntimeConfig",
    "Wave",
    "WaveScheduler",
    "FLUSH_FULL",
    "FLUSH_DEADLINE",
    "FLUSH_DRAIN",
]
