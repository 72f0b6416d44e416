"""The plain PyTorch versions of flash attention: forward attention, the
log-sum-exp the forward kernel writes for training, and the backward.
They are the kernels' oracles, and what the wrappers run for a tensor on
the CPU."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def band_mask(sq: int, sk: int, *, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) boolean: key j visible to query i when j <= i if causal,
    i - j < window if window > 0 (positions are indices)."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= qp - kp < window
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int):
    """Masked scaled scores (B, Hq, Sq, Sk) in f32 and the mask; the scale
    is q's hd^-0.5."""
    hq, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
    ok = band_mask(sq, sk, causal=causal, window=window, device=q.device)
    return s.masked_fill(~ok, float("-inf")), ok


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Sk, hd)
    v: torch.Tensor,  # (B, Hkv, Sk, vd)
    *,
    causal: bool = True,
    window: int = 0,
    p_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Masked softmax attention with the flash kernel's semantics:
    kv head = q head // (Hq / Hkv), scale q's hd^-0.5 (v's vd may differ,
    as in MLA), positions are indices (`band_mask`), and a fully masked
    row gives 0.  Returns (B, Hq, Sq, vd) in q's dtype.

    Scores and softmax statistics are f32.  `p_dtype` is the type P meets
    v in: bf16 by default for bf16 inputs (the reference's default
    `flash_p_dtype`, and its kernel's cast of P to v's dtype), f32
    otherwise.  At f32 this is the softmax times f32 v; at bf16 the
    numerator exp(s - m) and v are rounded to bf16, their products summed
    in f32 and divided by the f32 row sum of the unrounded numerator, as
    the reference's flash does."""
    if p_dtype is None:
        p_dtype = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    s, _ = _scores(q, k, causal, window)
    v = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    if p_dtype == torch.float32:
        p = torch.softmax(s, dim=-1)
        p = torch.nan_to_num(p, nan=0.0)
        return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # 0 where masked
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(p_dtype).float(), v.to(p_dtype).float())
    return (o / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)).to(q.dtype)


def lse_ref(
    q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """The log-sum-exp of each row's masked scaled scores, (B, Hq, Sq) f32,
    0 for a row that sees no key: the reference's `lse` (`log(l) + m`)."""
    s, _ = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, Hq, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Sk, hd)
    v: torch.Tensor,  # (B, Hkv, Sk, vd)
    o: torch.Tensor,  # (B, Hq, Sq, vd), the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq), the forward's log-sum-exp
    do: torch.Tensor,  # (B, Hq, Sq, vd), the gradient of o
    *,
    causal: bool = True,
    window: int = 0,
    p_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention, after the reference's `_flash_bwd`
    (`src/repro/models/flash_attention.py`) in one dense pass: P is
    recomputed from q, k and the forward's `lse` (never from a stored
    softmax), delta = rowsum(dO o), dS = P (dO v^T - delta); a kv head's
    gradients sum over its q heads; the scale is q's hd^-0.5.  Computed
    in f32 from the inputs upcast, each gradient rounded once to its
    input's dtype.  `p_dtype` is the type P meets dO in for dV, as the
    forward's `attention_ref` takes it: bf16 by default for bf16 inputs
    (the reference's `pc = p.astype(p_dtype)`), f32 otherwise; dS uses
    the f32 P."""
    b, hq, sq, hd = q.shape
    hkv, sk, vd = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = hd ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, g, sq, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, hkv, g, sq, vd)
    of = o.float().reshape(b, hkv, g, sq, vd)
    delta = (dof * of).sum(-1)  # (B, Hkv, g, Sq)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    ok = band_mask(sq, sk, causal=causal, window=window, device=q.device)
    p = torch.where(ok, torch.exp(s - lse.float().reshape(b, hkv, g, sq)[..., None]),
                    torch.zeros_like(s))
    if p_dtype is None:
        p_dtype = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(p_dtype).float(), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return (dq.reshape(b, hq, sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
