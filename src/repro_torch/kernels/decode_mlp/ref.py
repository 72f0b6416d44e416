"""The plain PyTorch version of the fused decode MLP (the kernel's oracle,
and what the wrapper runs for a tensor on the CPU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def decode_mlp_ref(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """SwiGLU y = (silu(x W1) * x W3) W2 in f32; x (B, d)."""
    xf = x.float()
    h = F.silu(xf @ w1.float()) * (xf @ w3.float())
    return (h @ w2.float()).to(x.dtype)
