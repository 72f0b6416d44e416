"""Attention: GQA (+bias, +qk-norm, +sliding window), prefill and decode.

Prefill runs full-sequence attention through the flash-attention kernel
(its plain version on the CPU).  Decode attends over the cache in one
masked pass (the reference's one-shot path of `chunked_attention`), in
plain torch.  Local layers keep a ring buffer of `window` slots, global
layers a dense `max_len` cache; `pos < 0` marks an empty slot.

MLA (DeepSeek-V3's latent attention) is not ported yet.

Caches are updated in place at decode (one slot per step), where the
reference returns a new cache: it saves copying every cache each step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rotary, dense_init, rms_norm

Cache = Dict[str, torch.Tensor]


def full_attention(
    q: torch.Tensor,  # (B, S, Hq, hd)
    k: torch.Tensor,  # (B, S, Hkv, hd)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Causal prefill self-attention, (B, S, Hq, hd).  Every row's positions are
    0..S-1 (`lm_prefill` builds them so), so the kernel's index masks are
    the reference's position masks.  The (B, H, S, hd) views handed to the
    kernel are transposes of the model's layout; it reads them in place
    and writes its output in q's layout."""
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=int(window or 0),
    )
    return out.transpose(1, 2)


def _mask(q_pos, kv_pos, window: int) -> torch.Tensor:
    """(B, Sq, Sk) causal boolean mask. kv_pos < 0 marks empty cache
    slots."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    ok = (kp >= 0) & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return ok


def decode_attention(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, vd)
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Sk)
    *,
    window: int = 0,
) -> torch.Tensor:
    """One causal masked pass over the whole cache (no KV loop), f32 statistics;
    a fully masked row gives 0."""
    b, sq, hq, hd = q.shape
    hkv, vd = k.shape[2], v.shape[3]
    g = hq // hkv
    qf = (q * hd ** -0.5).reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgd,bchd->bhgqc", qf.float(), k.float())
    msk = _mask(q_pos, kv_pos, window)[:, None, None]
    s = s.masked_fill(~msk, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(msk, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqc,bchd->bhgqd", p.to(v.dtype), v).float()
    out = out / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, vd).to(q.dtype)


def init_attn(gen, cfg: ArchConfig, dtype, device) -> Dict[str, torch.Tensor]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, hq * hd), dtype, device),
        "wk": dense_init(gen, (d, hkv * hd), dtype, device),
        "wv": dense_init(gen, (d, hkv * hd), dtype, device),
        "wo": dense_init(gen, (hq * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        for nm, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[nm] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig):
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, s = x.shape[:2]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_forward(
    p,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg: ArchConfig,
    *,
    window: int = 0,
    return_kv: bool = False,
):
    """Full-sequence causal self-attention (prefill)."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rotary(q, positions, cfg.rope_theta)
    k = apply_rotary(k, positions, cfg.rope_theta)
    out = full_attention(q, k, v, window=window)
    b, s = x.shape[:2]
    y = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(
    cfg: ArchConfig, batch: int, max_len: int, window: int, dtype, device
) -> Cache:
    """window > 0 => ring buffer of that length; else dense max_len cache."""
    length = window if window and window > 0 else max_len
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, length, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def fill_kv_cache(
    cache: Cache, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> Cache:
    """Write prefill K/V (length S) into a cache (length >= S or ring)."""
    length = cache["k"].shape[1]
    s = k.shape[1]
    if s >= length:  # ring cache shorter than the prefix: keep the tail,
        # rotated so that position p sits at slot p % length (decode layout)
        tail = s - length
        shift = (s - length) % length
        k = torch.roll(k[:, tail:], shift, dims=1)
        v = torch.roll(v[:, tail:], shift, dims=1)
        positions = torch.roll(positions[:, tail:], shift, dims=1)
        s = length
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    cache["pos"][:, :s] = positions.to(torch.int32)
    return cache


def attn_decode(
    p,
    x: torch.Tensor,  # (B, 1, D)
    pos: int,  # current position
    cache: Cache,
    cfg: ArchConfig,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, Cache]:
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rotary(q, positions, cfg.rope_theta)
    k = apply_rotary(k, positions, cfg.rope_theta)
    slot = pos % cache["k"].shape[1]  # ring for window caches; identity for dense
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][:, slot] = pos
    out = decode_attention(
        q, cache["k"], cache["v"], positions, cache["pos"],
        window=int(window or 0),
    )
    return out.reshape(b, 1, -1) @ p["wo"], cache
