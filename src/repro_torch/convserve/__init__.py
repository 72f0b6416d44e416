"""convserve -- ConvNet inference engine over the paper's algorithms.

Pipeline:  NetSpec --plan_net--> NetPlan (v3: layer plans + fusion
groups) --program.lower--> ExecProgram (staged IR, cross-layer fusion
groups) --Engine.compile--> CompiledNet --ConvServer--> batched serving,
or --ReplicaPool--> ServeRuntime for continuous traffic.

Everything runs on one device per `Engine`: cuda unless the caller
passes ``device="cpu"``.  `repro_torch.convserve.adapt` closes the loop:
measured stage costs replace the roofline when it mispredicts, with
shadow A/B verification and zero-downtime plan hot swap
(`AdaptController` / `MeasuredCostStore`, re-exported here).
"""

from repro_torch.core.registry import ConvSpec
from repro_torch.convserve.adapt import (
    AdaptConfig,
    AdaptController,
    MeasuredCostStore,
    ShadowVerifier,
    hot_swap,
)
from repro_torch.convserve.cache import KernelCache
from repro_torch.convserve.engine import CompiledNet, Engine
from repro_torch.convserve.executor import NetExecutor
from repro_torch.convserve.graph import (
    LayerSpec,
    NetSpec,
    bias,
    conv,
    init_weights,
    maxpool,
    relu,
    run_direct,
)
from repro_torch.convserve.plan import FusionGroup, LayerPlan, NetPlan
from repro_torch.convserve.planner import (
    plan_fusion_groups,
    plan_layer,
    plan_net,
    upgrade_plan,
)
from repro_torch.convserve.program import (
    EpilogueOp,
    ExecProgram,
    Stage,
    StageUnit,
    lower,
)
from repro_torch.convserve.runtime import (
    RealClock,
    Rejection,
    ReplicaPool,
    Request,
    RuntimeConfig,
    ServeRuntime,
    SimClock,
    Telemetry,
    WaveScheduler,
)
from repro_torch.convserve.serving import ConvServeConfig, ConvServer, ImageRequest
from repro_torch.convserve.weights import from_jax

__all__ = [
    "ConvSpec",
    "LayerSpec",
    "NetSpec",
    "conv",
    "bias",
    "relu",
    "maxpool",
    "init_weights",
    "run_direct",
    "from_jax",
    "LayerPlan",
    "NetPlan",
    "FusionGroup",
    "plan_layer",
    "plan_net",
    "plan_fusion_groups",
    "upgrade_plan",
    "EpilogueOp",
    "StageUnit",
    "Stage",
    "ExecProgram",
    "lower",
    "Engine",
    "CompiledNet",
    "KernelCache",
    "NetExecutor",
    "ConvServer",
    "ConvServeConfig",
    "ImageRequest",
    "RuntimeConfig",
    "ServeRuntime",
    "ReplicaPool",
    "WaveScheduler",
    "Request",
    "Rejection",
    "Telemetry",
    "RealClock",
    "SimClock",
    "AdaptConfig",
    "AdaptController",
    "MeasuredCostStore",
    "ShadowVerifier",
    "hot_swap",
]
