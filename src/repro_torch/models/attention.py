"""Attention: GQA (+bias, +qk-norm, +sliding window) and MLA, prefill and
decode; self-attention (causal, or bidirectional in an encoder) and
cross attention (an encoder-decoder's decoder over the encoder's output).

`runtime_flags.FLAGS.attention_impl` picks the implementation, as in the
reference.  Under "flash" (the default) full-sequence attention --
training, prefill, the encoder, and cross attention at every step,
decode included -- runs through the flash kernel (its plain version on
the CPU) via `models.flash_attention.flash_attention`: under grad
(training) that is `FlashAttention`, whose backward is the flash
backward kernel.  Under "chunked" (the baseline) it runs through
`chunked_attention`'s online-softmax loop over 512-key chunks, plain
torch as the reference's XLA scan, differentiated by autograd.  A
non-empty `attention_cp_axis` also takes `chunked_attention`; while a
device mesh is in effect (`distributed.sharding.use_mesh`) and its
`attention_cp_axis` axis M is larger than 1, that is context
parallelism, as the reference's: q and its positions in M contiguous
sequence stripes, the batch over ``data``, each stripe run on its card
with a whole copy of K, V and their positions, the outputs brought back
to q's card in order (`cp_attention`).  Without a mesh in effect, with
a logical one or with M of 1 it runs whole on q's card.  Decode self-attention
goes through `chunked_attention` over the cache: one masked pass under
"flash" at any cache length, the chunk loop under "chunked".  Local
layers keep a ring buffer of `window` slots, global layers a dense
`max_len` cache; `pos < 0` marks an empty slot.

Cross attention projects q from the decoder's x and k / v from the
encoder's output (`cross_x`); it gets no rotary and no mask (every
frame is visible), as in the reference, so it takes any Sq and Sk.

MLA (DeepSeek-V3's multi-head latent attention) projects x to a q
latent and a kv latent (`c_kv`, kv_lora_rank wide) plus one shared
rotary key (`k_rope`); prefill and training expand the latent to
per-head k (nope + rope dims, 192 at full width) and v (128) and run the
same attention as GQA, at q/k and v head dims apart.  Its decode cache
holds only the latents (`c_kv`, `k_rope`, `pos`).  Decode is the
weight-absorbed form (`mla_decode_absorbed`) under `mla_absorb` (the
default); without it (the baseline) the latents of the whole cache are
expanded every step and attended by `chunked_attention`.

Caches are updated in place at decode (one slot per step), where the
reference returns a new cache: it saves copying every cache each step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.distributed import sharding as mesh_rules  # module: a cycle through FLAGS
from repro_torch.models.common import apply_rotary, dense_init, rms_norm
from repro_torch.models.flash_attention import flash_attention
from repro_torch.models.runtime_flags import FLAGS

KV_CHUNK = 512  # the chunked loop's key block length

Cache = Dict[str, torch.Tensor]


def full_attention(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, vd): vd may differ from hd (MLA)
    *,
    window: int = 0,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention, (B, Sq, Hq, vd), scale hd^-0.5, by
    `FLAGS` (module docstring).  A causal or windowed call has Sq == Sk
    and every row's positions 0..S-1 (`lm_prefill` builds them so), so
    the kernel's index masks are the reference's position masks, and the
    chunked path gets those positions; a non-causal one without a window
    masks nothing and takes any Sk.  The (B, H, S, hd) views handed to
    the kernel are transposes of the model's layout; it reads them in
    place and writes its output in q's layout.  Under grad the kernel
    call is `FlashAttention`'s; otherwise (serving) the forward kernel
    alone runs."""
    if FLAGS.attention_cp_axis or FLAGS.attention_impl != "flash":
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        q_pos = torch.arange(sq, dtype=torch.int32, device=q.device).expand(b, sq)
        kv_pos = torch.arange(sk, dtype=torch.int32, device=q.device).expand(b, sk)
        mesh = mesh_rules.current_mesh() if FLAGS.attention_cp_axis else None
        if mesh is not None and not mesh.logical and mesh.shape.get(FLAGS.attention_cp_axis, 1) > 1:
            return cp_attention(q, k, v, q_pos, kv_pos, mesh, FLAGS.attention_cp_axis,
                                window=window, causal=causal)
        return chunked_attention(q, k, v, q_pos, kv_pos, window=window, causal=causal)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return flash_attention(qt, kt, vt, causal=causal, window=window).transpose(1, 2)


def cp_attention(q, k, v, q_pos, kv_pos, mesh, axis: str, *, window: int = 0,
                 causal: bool = True) -> torch.Tensor:
    """Context-parallel attention, the reference's ``P("data", axis, None,
    None)`` on q: the batch split over ``data`` where it divides (else
    whole on every data group), q's sequence into ``mesh.shape[axis]``
    contiguous stripes, each (batch block, stripe) on its card
    (`shard_devices`) with a whole copy of its batch block's K, V and
    `kv_pos`, run by `chunked_attention` (stripes as `tensor_split` cuts,
    the earlier ones a row longer).  Every stripe is issued before any
    output is read; the outputs come back to q's card in order."""
    nd = mesh.shape.get("data", 1)
    nd = nd if nd > 1 and q.shape[0] % nd == 0 else 1
    m = mesh.shape[axis]
    cards = mesh_rules.shard_devices(mesh, ("data", axis) if nd > 1 else axis)
    # every stripe's inputs on its card first: a copy between cards is
    # queued on the source card's stream, so one queued after a stripe's
    # kernels there would wait for them
    staged = []
    blocks = zip(*(t.tensor_split(nd) for t in (q, q_pos, k, v, kv_pos)))
    for i, (qb, pb, kb, vb, kpb) in enumerate(blocks):
        for j, (qs, ps) in enumerate(zip(qb.tensor_split(m, dim=1), pb.tensor_split(m, dim=1))):
            if qs.shape[1]:
                staged.append((i, [t.to(cards[i * m + j]) for t in (qs, ps, kb, vb, kpb)]))
    outs = [(i, chunked_attention(qs, ks, vs, qp, kp, window=window, causal=causal))
            for i, (qs, qp, ks, vs, kp) in staged]
    return torch.cat([torch.cat([o.to(q.device) for j, o in outs if j == i], dim=1)
                      for i in range(nd)], dim=0)


def _mask(q_pos, kv_pos, window: int, causal: bool) -> torch.Tensor:
    """(B, Sq, Sk) boolean mask. kv_pos < 0 marks empty cache slots;
    window <= 0 is global."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return ok


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, vd)
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Sk)
    *,
    window: int = 0,
    causal: bool = True,
    chunk: int = KV_CHUNK,
) -> torch.Tensor:
    """Masked attention by positions, (B, Sq, Hq, vd), scale hd^-0.5, q
    scaled in its own dtype, scores and statistics in f32, the output in
    q's dtype; a fully masked row gives 0.  Plain torch, as the reference
    leaves it to XLA.  Two branches, as the reference's:

    - the one-shot pass, under `attention_impl == "flash"` when Sq == 1
      (decode, at any cache length) or one chunk holds every key: one
      masked softmax over all keys, P cast to v's dtype and its products
      with v summed in f32 (a bf16 product is exact in f32), the row sum
      divided out in f32;
    - otherwise the online-softmax loop over `chunk`-key blocks (keys
      padded to a multiple of `chunk` at position -1, masked): a running
      max, row sum and f32 accumulator, each rescaled per block, P and v
      in f32, rows masked so far guarded.  Under grad autograd
      differentiates the loop, as XLA differentiates the reference's
      scan."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    vd = v.shape[3]
    g = hq // hkv
    window = int(window or 0)
    qf = (q * hd ** -0.5).reshape(b, sq, hkv, g, hd).float()

    if (sq == 1 or chunk >= sk) and FLAGS.attention_impl == "flash":
        s = torch.einsum("bqhgd,bchd->bhgqc", qf, k.float())
        msk = _mask(q_pos, kv_pos, window, causal)[:, None, None]
        s = s.masked_fill(~msk, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(msk, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhgqc,bchd->bhgqd", p.to(v.dtype).float(), v.float())
        out = out / torch.clamp(l, min=1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, vd).to(q.dtype)

    pad = (-sk) % chunk
    k, v = k.float(), v.float()
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    m = torch.full((b, hkv, g, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, vd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk + pad, chunk):
        kc, vc, pc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], kv_pos[:, c0:c0 + chunk]
        s = torch.einsum("bqhgd,bchd->bhgqc", qf, kc)  # (B, Hkv, g, Sq, c)
        msk = _mask(q_pos, pc, window, causal)[:, None, None]  # (B, 1, 1, Sq, c)
        s = torch.where(msk, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row masked so far has m == -inf: it is guarded to 0, so a masked
        # score's exp and a masked row's correction exp(m - 0) are exact zeros
        m_safe = torch.nan_to_num(m_new, neginf=0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqc,bchd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
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
    length = cache["k"].shape[1]
    out = chunked_attention(
        q, cache["k"], cache["v"], positions, cache["pos"],
        window=int(window or 0), causal=True, chunk=min(KV_CHUNK, length),
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
    """Full-sequence causal MLA (training, prefill): `full_attention` (the
    flash kernel, or the chunked loop) at q/k head dim nope + rope and v
    head dim v_head_dim, scale (nope + rope)^-0.5."""
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
    absorbed attention over the cache under `mla_absorb`; without it the
    whole cache's latents are expanded to per-head k / v and attended by
    `chunked_attention`."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv_latent(p, x, positions, cfg)
    cache["c_kv"][:, pos] = c_kv[:, 0]
    cache["k_rope"][:, pos] = k_rope[:, 0]
    cache["pos"][:, pos] = pos
    if FLAGS.mla_absorb:
        return mla_decode_absorbed(p, q, cache, cfg), cache
    k, v = _mla_expand(p, cache["c_kv"], cache["k_rope"], cfg)
    out = chunked_attention(q, k, v, positions, cache["pos"], causal=True)
    return out.reshape(b, 1, -1) @ p["wo"], cache


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
