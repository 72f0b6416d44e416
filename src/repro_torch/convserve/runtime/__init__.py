"""Online serving runtime for the convserve engine.

Request lifecycle:  submit -> admit (bounded per-bucket queues,
priority classes, reject-with-reason) -> deadline-aware wave formation
(`WaveScheduler`) -> replica pool sharing one pre-transformed kernel
cache (`ReplicaPool`) -> telemetry (latency histograms, queue depth,
wave/reject counters, cache + stage rollups in one JSON document).

Everything is driven through an injectable `Clock`: `RealClock` for
traffic, `SimClock` for deterministic scheduling tests.  The offline
`ConvServer` front-end reuses the same scheduler (admit everything,
drain), so wave formation has exactly one implementation.
"""

from repro_torch.convserve.runtime.clock import Clock, RealClock, SimClock
from repro_torch.convserve.runtime.loadgen import (
    Arrival,
    burst_trace,
    diurnal_rate,
    diurnal_trace,
    make_images,
    merge_traces,
    poisson_trace,
)
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
from repro_torch.convserve.runtime.replicas import ReplicaPool, WaveResult
from repro_torch.convserve.runtime.scheduler import (
    FLUSH_DEADLINE,
    FLUSH_DRAIN,
    FLUSH_FULL,
    RuntimeConfig,
    Wave,
    WaveScheduler,
)
from repro_torch.convserve.runtime.service import ServeRuntime
from repro_torch.convserve.runtime.telemetry import (
    Histogram,
    Telemetry,
    stage_rollup,
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
    "ReplicaPool",
    "WaveResult",
    "ServeRuntime",
    "Telemetry",
    "Histogram",
    "stage_rollup",
    "Arrival",
    "poisson_trace",
    "burst_trace",
    "diurnal_rate",
    "diurnal_trace",
    "merge_traces",
    "make_images",
]
