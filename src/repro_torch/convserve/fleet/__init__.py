"""Elastic fleet serving: sharded waves, autoscaling, fault tolerance.

The fleet subsystem turns the single-pool serving runtime into a
distributed one:

  * `sharding` -- split one wave's rows into shards (on one card, row
    groups through the replica's one program; a multi-card mesh raises)
    and decide, per layer, whether pre-transformed kernels replicate or
    shard;
  * `pool` -- an elastic replica pool with lifecycle states, a
    discrete-event simulation core, injectable faults, and health
    probes that detect (and repair) shared-cache corruption;
  * `autoscaler` -- the telemetry-driven controller growing and
    shrinking the fleet with hysteresis, cooldown, and an admission cap
    while newcomers warm;
  * `service` -- `FleetRuntime`, the `ServeRuntime` subclass that runs
    the whole thing on a simulated or real clock.

Every wave runs through the replica's compiled net, so on the card each
one launches the CUDA tile kernel wherever the plan runs a tile
algorithm.
"""

from repro_torch.convserve.fleet.autoscaler import (  # noqa: F401
    Autoscaler,
    AutoscalerConfig,
)
from repro_torch.convserve.fleet.pool import (  # noqa: F401
    DRAINING,
    ElasticPool,
    FAILED,
    FixedServiceModel,
    LOSS_NO_HEALTHY_REPLICA,
    LOSS_REASONS,
    LOSS_RETRIES_EXHAUSTED,
    QUARANTINED,
    READY,
    RETIRED,
    Replica,
    STARTING,
    WaveLoss,
)
from repro_torch.convserve.fleet.service import FleetRuntime  # noqa: F401
from repro_torch.convserve.fleet.sharding import (  # noqa: F401
    REPLICATE,
    SHARD,
    ShardedWaveExecutor,
    apply_placement,
    plan_weight_placement,
    probe_image,
    shard_bounds,
)
