"""The fused SwiGLU decode MLP's entry point.

The device decides the path: a CUDA tensor launches the CUDA kernel
(`kernel.decode_mlp_call`) or raises, a CPU tensor runs the plain version
(`ref.decode_mlp_ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_mlp import kernel as _kernel
from repro_torch.kernels.decode_mlp.ref import decode_mlp_ref


def decode_mlp(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """Fused SwiGLU MLP y = (silu(xW1) * xW3) W2 for decode-sized x (B, d);
    B and d_ff need not be multiples of any block size."""
    if x.device.type == "cuda":
        return _kernel.decode_mlp_call(x.contiguous(), w1, w3, w2)
    return decode_mlp_ref(x, w1, w3, w2)
