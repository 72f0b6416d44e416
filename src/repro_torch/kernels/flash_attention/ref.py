"""The plain PyTorch version of forward attention (the flash kernel's
oracle, and what the wrapper runs for a tensor on the CPU)."""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Sk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Masked softmax attention in f32 with the flash kernel's semantics:
    kv head = q head // (Hq / Hkv), scale hd^-0.5, positions are indices
    (key j visible to query i when j <= i if causal, i - j < window if
    window > 0), and a fully masked row gives 0."""
    hq, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= qp - kp < window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
