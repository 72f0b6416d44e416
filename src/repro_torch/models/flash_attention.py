"""Flash attention with a gradient: the port's form of the reference's
custom VJP (`src/repro/models/flash_attention.py`, `_flash`).

`FlashAttention` is a `torch.autograd.Function`.  Its forward launches the
flash kernel with the log-sum-exp written beside the output and saves q,
k, v, o and lse; its backward launches the backward kernel, which
recomputes P per tile from them (P is never stored, so the residuals are
O(S * hd), not O(S^2)).  On the CPU both run their plain versions.

Positions are indices (the kernels' masks).  The reference aligns a
causal mask at the end (`offset = Sk - Sq`); the two agree when Sq == Sk,
which is all that training calls, so anything else is refused.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) on (B, H, S, hd) tensors, with the flash
    backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Hq, S, hd)
    k: torch.Tensor,  # (B, Hkv, S, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Self-attention that autograd can differentiate: (B, Hq, S, hd)."""
    if q.shape[2] != k.shape[2]:
        raise ValueError(
            f"attention under grad needs Sq == Sk (index positions agree with the "
            f"reference's end-aligned mask only then), got Sq={q.shape[2]}, Sk={k.shape[2]}")
    return FlashAttention.apply(q, k, v, bool(causal), int(window or 0))
