"""repro_torch.core -- L3-fused transformed convolutions in PyTorch.

The public surface is `ConvSpec` (the problem), the algorithm registry
(`repro_torch.core.registry`: plan/prepare/execute lifecycle), and
`conv2d` (the thin dispatcher).
"""

from repro_torch.core.conv import conv2d, conv2d_direct
from repro_torch.core.fused import conv2d_l3_fused
from repro_torch.core.registry import AlgoPlan, Algorithm, ConvSpec, plan_conv
from repro_torch.core.three_stage import conv2d_three_stage

__all__ = [
    "Algorithm",
    "AlgoPlan",
    "ConvSpec",
    "plan_conv",
    "conv2d",
    "conv2d_direct",
    "conv2d_l3_fused",
    "conv2d_three_stage",
]
