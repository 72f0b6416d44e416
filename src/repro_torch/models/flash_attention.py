"""Flash attention with a gradient: the port's form of the reference's
custom VJP (`src/repro/models/flash_attention.py`, `_flash`).

`FlashAttention` is a `torch.autograd.Function`.  Its forward launches the
flash kernel with the log-sum-exp written beside the output and saves q,
k, v, o and lse; its backward launches the backward kernel, which
recomputes P per tile from them (P is never stored, so the residuals are
O(S * hd), not O(S^2)).  On the CPU both run their plain versions.

`flash_attention` is what the model's attention calls: `FlashAttention`
when an input needs a gradient, else the forward kernel alone (serving).
Both kernels take fp32 and bf16 (the backward's bf16 instantiation
rounds P to bf16 for dV, as the reference's `_flash_bwd`); on the card
any other dtype under grad raises.  On the CPU the plain backward takes
either.

Positions are indices (the kernels' masks).  The reference aligns a
causal or windowed mask at the end (`offset = Sk - Sq`); the two agree
when Sq == Sk, so a causal or windowed call at Sq != Sk is refused.  A
non-causal mask without a window reads no position (the reference's is
`kv_pos >= 0` alone, true for every key), so cross attention and the
encoder's self-attention take any Sq and Sk.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_forward,
)


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
    q: torch.Tensor,  # (B, Hq, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Sk, hd)
    v: torch.Tensor,  # (B, Hkv, Sk, vd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention that autograd can differentiate: (B, Hq, Sq, vd).  Under
    grad (an input needs one) the call is `FlashAttention`'s, which also
    writes the log-sum-exp for the backward; otherwise the forward kernel
    alone runs.  Sq may differ from Sk only without a causal mask or a
    window."""
    window = int(window or 0)
    if q.shape[2] != k.shape[2] and (causal or window):
        raise ValueError(
            f"a causal or windowed mask needs Sq == Sk (index positions agree with the "
            f"reference's end-aligned mask only then), got Sq={q.shape[2]}, Sk={k.shape[2]}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cuda" and q.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"flash attention under grad takes float32 or bfloat16 on the card, got "
                f"{q.dtype}: the backward kernel has no other instantiation")
        return FlashAttention.apply(q, k, v, bool(causal), window)
    return flash_forward(q, k, v, causal=causal, window=window)
