from repro_torch.kernels.conv1d_fused.kernel import cost
from repro_torch.kernels.conv1d_fused.ops import Conv1dFused, conv1d_fused
from repro_torch.kernels.conv1d_fused.ref import conv1d_bwd_ref, conv1d_ref

__all__ = ["cost", "Conv1dFused", "conv1d_bwd_ref", "conv1d_fused", "conv1d_ref"]
