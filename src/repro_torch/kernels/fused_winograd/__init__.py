from repro_torch.kernels.fused_winograd.ops import conv2d_fused_pallas
from repro_torch.kernels.fused_winograd.ref import conv2d_ref

__all__ = ["conv2d_fused_pallas", "conv2d_ref"]
