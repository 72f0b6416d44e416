from repro_torch.kernels.conv1d_fused.ops import conv1d_fused
from repro_torch.kernels.conv1d_fused.ref import conv1d_ref

__all__ = ["conv1d_fused", "conv1d_ref"]
