"""The plain PyTorch version of the fused causal conv1d (the kernel's
oracle, and what the wrapper runs for a tensor on the CPU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    activation: str = "silu",
) -> torch.Tensor:
    """x (B, L, D), w (K, D), b (D,) -> (B, L, D) causal depthwise conv,
    computed in f32: K shifted multiply-accumulates, + bias, then SiLU
    when `activation` is "silu"."""
    if activation not in ("silu", "none"):
        raise ValueError(f"activation must be 'silu' or 'none', got {activation!r}")
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + xp[:, i : i + length, :] * w[i].float()
    acc = acc + b.float()
    if activation == "silu":
        acc = F.silu(acc)
    return acc.to(x.dtype)
