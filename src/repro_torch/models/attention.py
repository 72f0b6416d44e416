"""Attention: GQA (+bias, +qk-norm, +sliding window) and MLA, prefill and
decode; self-attention (causal, or bidirectional in an encoder) and
cross attention (an encoder-decoder's decoder over the encoder's output).

Full-sequence attention -- training, prefill, the encoder, and cross
attention at every step, decode included -- runs through the flash
kernel (its plain version on the CPU) via
`models.flash_attention.flash_attention`: under grad (training) that is
`FlashAttention`, whose backward is the flash backward kernel.  Decode
self-attention attends over the cache in one masked pass (the
reference's one-shot path of `chunked_attention`), in plain torch.
Local layers keep a ring buffer of `window` slots, global layers a dense
`max_len` cache; `pos < 0` marks an empty slot.

Cross attention projects q from the decoder's x and k / v from the
encoder's output (`cross_x`); it gets no rotary and no mask (every
frame is visible), as in the reference, so it takes any Sq and Sk.

MLA (DeepSeek-V3's multi-head latent attention) projects x to a q
latent and a kv latent (`c_kv`, kv_lora_rank wide) plus one shared
rotary key (`k_rope`); prefill and training expand the latent to
per-head k (nope + rope dims, 192 at full width) and v (128) and run the
same flash kernel as GQA, at q/k and v head dims apart.  Its decode cache
holds only the latents (`c_kv`, `k_rope`, `pos`), and decode is the
weight-absorbed form (`mla_decode_absorbed`): the reference's default
(`mla_absorb=True`), the only decode the port has.

Caches are updated in place at decode (one slot per step), where the
reference returns a new cache: it saves copying every cache each step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.models.flash_attention import flash_attention
from repro_torch.models.common import apply_rotary, dense_init, rms_norm

Cache = Dict[str, torch.Tensor]


def full_attention(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, vd): vd may differ from hd (MLA)
    *,
    window: int = 0,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention, (B, Sq, Hq, vd), scale hd^-0.5.  A causal
    or windowed call has Sq == Sk and every row's positions 0..S-1
    (`lm_prefill` builds them so), so the kernel's index masks are the
    reference's position masks; a non-causal one without a window masks
    nothing and takes any Sk.  The (B, H, S, hd) views handed to the
    kernel are transposes of the model's layout; it reads them in place
    and writes its output in q's layout.  Under grad the call is
    `FlashAttention`'s; otherwise (serving) the forward kernel alone
    runs."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return flash_attention(qt, kt, vt, causal=causal, window=window).transpose(1, 2)


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
    """One causal masked pass over the whole cache (no KV loop), the
    reference's one-shot path (which it takes for caches of up to 512
    slots; a longer one it walks in 512-slot chunks with P in f32): q
    scaled in its own dtype, f32 scores and statistics, P cast to v's
    dtype and its products with v summed in f32 (a bf16 product is exact
    in f32), the row sum divided out in f32, the output in q's dtype; a
    fully masked row gives 0."""
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
    out = torch.einsum("bhgqc,bchd->bhgqd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, vd).to(q.dtype)


def init_lora(gen, cfg: ArchConfig, rank: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Low-rank q, k and v deltas, ``lora_{q,k,v}_{a,b}``: a (d, rank) drawn
    as a dense layer, b (rank, width) zeros, so a fresh delta adds nothing.
    The reference draws the three a's from one key, equal at init; here
    each has its own draw from `gen`, of the same distribution."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {}
    for nm, width in (("q", hq * hd), ("k", hkv * hd), ("v", hkv * hd)):
        p[f"lora_{nm}_a"] = dense_init(gen, (d, rank), dtype, device)
        p[f"lora_{nm}_b"] = torch.zeros((rank, width), dtype=dtype, device=device)
    return p


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


def _project_qkv(p, x: torch.Tensor, x_kv: torch.Tensor, cfg: ArchConfig):
    """q (B, Sq, Hq, hd) from x, k and v (B, Sk, Hkv, hd) from x_kv (x
    itself for self-attention); with ``lora_*`` leaves in `p` (zamba2's
    shared block) each projection adds its low-rank delta (x a) b before
    bias, reshape and qk-norm, as the reference does."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if "lora_q_a" in p:
        q = q + (x @ p["lora_q_a"]) @ p["lora_q_b"]
        k = k + (x_kv @ p["lora_k_a"]) @ p["lora_k_b"]
        v = v + (x_kv @ p["lora_v_a"]) @ p["lora_v_b"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, sq = x.shape[:2]
    sk = x_kv.shape[1]
    q = q.reshape(b, sq, hq, hd)
    k = k.reshape(b, sk, hkv, hd)
    v = v.reshape(b, sk, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_forward(
    p,
    x: torch.Tensor,  # (B, S, D)
    positions: Optional[torch.Tensor],  # (B, S); cross attention reads none
    cfg: ArchConfig,
    *,
    window: int = 0,
    causal: bool = True,
    cross_x: Optional[torch.Tensor] = None,  # (B, S_src, D): the encoder's output
    return_kv: bool = False,
):
    """Full-sequence attention (training, prefill, the encoder).  Self-
    attention rotates q and k by `positions`, causal or (an encoder's)
    bidirectional.  With `cross_x` it is cross attention: k and v from
    `cross_x`, no rotary, no mask (the reference's `causal and cross_x is
    None`), so it reads no position of the frames; the reference's
    `cross_pos` has nothing to do here."""
    q, k, v = _project_qkv(p, x, x if cross_x is None else cross_x, cfg)
    if cross_x is None:  # self-attention gets rotary
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    out = full_attention(q, k, v, window=window, causal=causal and cross_x is None)
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
    q, k, v = _project_qkv(p, x, x, cfg)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ArchConfig, dtype, device) -> Dict[str, torch.Tensor]:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dtype, device),
        "q_a_norm": torch.zeros((m.q_lora_rank,), dtype=dtype, device=device),
        "wq_b": dense_init(gen, (m.q_lora_rank, h * qd), dtype, device),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_dim), dtype, device),
        "kv_a_norm": torch.zeros((m.kv_lora_rank,), dtype=dtype, device=device),
        "wk_b": dense_init(gen, (m.kv_lora_rank, h * m.qk_nope_dim), dtype, device),
        "wv_b": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), dtype, device),
        "wo": dense_init(gen, (h * m.v_head_dim, d), dtype, device),
    }


def _mla_q(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x -> q (B, S, H, nope + rope), its rope part rotated."""
    m: MLAConfig = cfg.mla
    b, s = x.shape[:2]
    cq = rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, s, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    return torch.cat([q_nope, apply_rotary(q_rope, positions, cfg.rope_theta)], dim=-1)


def _mla_kv_latent(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """x -> (c_kv normalised latent (B, S, kv_lora_rank), k_rope rotated
    (B, S, rope)): the decode cache's contents."""
    m: MLAConfig = cfg.mla
    ckv = x @ p["wkv_a"]
    c_kv = rms_norm(ckv[..., : m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rotary(ckv[..., m.kv_lora_rank :][:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def _mla_expand(p, c_kv: torch.Tensor, k_rope: torch.Tensor, cfg: ArchConfig):
    """latents -> per-head k (B, S, H, nope + rope), the rope part shared
    by every head, and v (B, S, H, v_head_dim)."""
    m: MLAConfig = cfg.mla
    b, s = c_kv.shape[:2]
    h = cfg.n_heads
    k_nope = (c_kv @ p["wk_b"]).reshape(b, s, h, m.qk_nope_dim)
    v = (c_kv @ p["wv_b"]).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)], dim=-1)
    return k, v


def mla_forward(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                return_latent: bool = False):
    """Full-sequence causal MLA (training, prefill): the flash kernel at
    q/k head dim nope + rope and v head dim v_head_dim, scale (nope +
    rope)^-0.5."""
    b, s = x.shape[:2]
    q = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv_latent(p, x, positions, cfg)
    k, v = _mla_expand(p, c_kv, k_rope, cfg)
    y = full_attention(q, k, v).reshape(b, s, -1) @ p["wo"]
    if return_latent:
        return y, (c_kv, k_rope)
    return y


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> Cache:
    m: MLAConfig = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def fill_mla_cache(cache: Cache, c_kv: torch.Tensor, k_rope: torch.Tensor,
                   positions: torch.Tensor) -> Cache:
    """Write the prefill's latents (length S <= max_len) into the cache."""
    s = c_kv.shape[1]
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    cache["pos"][:, :s] = positions.to(torch.int32)
    return cache


def mla_decode(p, x: torch.Tensor, pos: int, cache: Cache,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Cache]:
    """One decode step: the step's latents go to slot `pos`, then the
    absorbed attention over the cache."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv_latent(p, x, positions, cfg)
    cache["c_kv"][:, pos] = c_kv[:, 0]
    cache["k_rope"][:, pos] = k_rope[:, 0]
    cache["pos"][:, pos] = pos
    return mla_decode_absorbed(p, q, cache, cfg), cache


def mla_decode_absorbed(p, q: torch.Tensor, cache: Cache, cfg: ArchConfig) -> torch.Tensor:
    """Weight-absorbed MLA decode (DeepSeek-V3's inference form), in the
    kv_lora_rank-wide latent space:
        s = (q_nope W_uk) . c_kv + q_rope . k_rope
        o = (softmax(s) c_kv) W_uv, per head
    over the cache's filled slots (pos >= 0), scale (nope + rope)^-0.5.
    Plain einsums, as the reference leaves them to XLA, in the cache's
    dtype as the reference's are: each operand cast to it, the products
    summed in f32 (`_cdot`), the latents q_lat and o_lat and the softmax
    weights rounded to it between the products.  q: (B, 1, H, nope +
    rope); returns (B, 1, D)."""
    m: MLAConfig = cfg.mla
    b, h = q.shape[0], cfg.n_heads
    cdtype = cache["c_kv"].dtype

    def _cdot(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """einsum of x and y cast to the cache's dtype, summed in f32 (the
        reference's `preferred_element_type`)."""
        return torch.einsum(eq, x.to(cdtype).float(), y.to(cdtype).float())

    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    wk = p["wk_b"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_lat = _cdot("bqhn,rhn->bqhr", q_nope, wk)
    ckv, kr = cache["c_kv"], cache["k_rope"]
    s = _cdot("bqhr,bsr->bhqs", q_lat, ckv) + _cdot("bqhn,bsn->bhqs", q_rope, kr)
    s = s * (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    valid = (cache["pos"] >= 0)[:, None, None, :]
    w = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    w = torch.where(valid, w, torch.zeros_like(w))
    o_lat = _cdot("bhqs,bsr->bqhr", w, ckv)
    wv = p["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = _cdot("bqhr,rhv->bqhv", o_lat, wv).reshape(b, 1, h * m.v_head_dim)
    return o.to(q.dtype) @ p["wo"]
