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


def conv1d_bwd_ref(
    g: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    activation: str = "silu",
):
    """(dx, dw, db) of `conv1d_ref(x, w, b, activation=...)` for the output
    gradient `g`, computed in f32 and returned in each input's dtype:
    the pre-activation (the causal conv + bias) again, dpre = g *
    silu'(pre) (g when `activation` is "none"); dx the anti-causal conv
    of dpre with the taps, dx[t] = sum_i dpre[t+K-1-i] w[i]; dw[i] = sum
    over B, L of dpre * x shifted by K-1-i; db = sum over B, L of dpre.
    What XLA computes for the reference's `silu(conv1d_depthwise_causal(x,
    w) + b)`."""
    if activation not in ("silu", "none"):
        raise ValueError(f"activation must be 'silu' or 'none', got {activation!r}")
    k, length = w.shape[0], x.shape[1]
    dpre = g.float()
    if activation == "silu":
        pre = conv1d_ref(x, w, b, activation="none").float()
        s = torch.sigmoid(pre)
        dpre = dpre * (s * (1.0 + pre * (1.0 - s)))
    dp = F.pad(dpre, (0, 0, 0, k - 1))  # K-1 zero rows after the sequence
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty(wf.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        dx = dx + dp[:, k - 1 - i : k - 1 - i + length, :] * wf[i]
        dw[i] = (dpre * xp[:, i : i + length, :]).sum(dim=(0, 1))
    return dx.to(x.dtype), dw.to(w.dtype), dpre.sum(dim=(0, 1)).to(b.dtype)
