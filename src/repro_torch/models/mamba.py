"""Mamba2 (SSD -- state-space duality) block: chunked prefill scan + decode step.

Prefill uses the SSD chunked algorithm: within a chunk of Q steps the
quadratic dual form (C B^T . decay) runs as batched matmuls; across chunks
a Python loop carries the (H, P, N) state.  Decode is the O(1) recurrent
update.  The prefill's short depthwise-causal conv (+ bias + SiLU) is the
fused conv1d kernel on the card (its plain version on the CPU); under
grad it goes through `Conv1dFused`, whose backward is the conv1d
backward kernel.  The decode step's single-row conv
stays plain torch, as the reference computes it outside Pallas.

The chunk length is `runtime_flags.FLAGS.ssm_chunk_override`, or the
config's chunk when that is 0, and at most the sequence, as in the
reference.  Under grad with `FLAGS.ssm_chunk_remat` (the default) each
chunk step runs under its own `checkpoint(..., use_reentrant=False)`,
inside the per-super-block one when the stack remats: the backward
recomputes a chunk's (B, H, Q, Q) dual-form tensors instead of holding
every chunk's, as the reference's `jax.checkpoint(chunk_step)` does.
The gradients are the same either way.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels.conv1d_fused import conv1d_fused
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.runtime_flags import FLAGS

Cache = Dict[str, torch.Tensor]


def _dims(cfg: ArchConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_xbc = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, d_xbc


def init_mamba(gen, cfg: ArchConfig, dtype, device) -> Dict[str, torch.Tensor]:
    s, d_inner, h, d_xbc = _dims(cfg)
    d = cfg.d_model
    d_in_proj = d_inner + d_xbc + h  # z, xBC, dt
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), dtype, device),
        "conv_w": dense_init(gen, (s.d_conv, d_xbc), dtype, device, fan_in=s.d_conv),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "A_log": torch.zeros((h,), dtype=f32, device=device),  # A = -1 at init
        "D": torch.ones((h,), dtype=f32, device=device),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (d_inner, d), dtype, device, fan_in=d_inner),
    }


def _split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    _, d_inner, _, d_xbc = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner : d_inner + d_xbc]
    dt = zxbcdt[..., d_inner + d_xbc :]
    return z, xbc, dt


def _split_xbc(cfg: ArchConfig, xbc: torch.Tensor):
    s, d_inner, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return xbc[..., :d_inner], xbc[..., d_inner : d_inner + gn], xbc[..., d_inner + gn :]


def mamba_forward(p, x_in: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    """(B, S, D) -> (B, S, D); S is padded internally to a multiple of the
    chunk (padded steps get dt == 0: they neither decay nor feed the
    state).  With return_state, also returns the decode cache
    {conv, ssm} at the end of the sequence."""
    s, d_inner, h, _ = _dims(cfg)
    bsz, seq, _ = x_in.shape
    q = min(FLAGS.ssm_chunk_override or s.chunk, seq)
    pad = (-seq) % q
    if pad:
        x_in = F.pad(x_in, (0, 0, 0, pad))
    seq_p = seq + pad
    nc = seq_p // q

    zxbcdt = x_in @ p["in_proj"]
    z, xbc_raw, dt_raw = _split(cfg, zxbcdt)
    xbc = conv1d_fused(xbc_raw, p["conv_w"], p["conv_b"], activation="silu")
    xs, bmat, cmat = _split_xbc(cfg, xbc)

    g, n, hd = s.n_groups, s.d_state, s.head_dim
    f32 = torch.float32
    xs = xs.reshape(bsz, nc, q, h, hd)
    bmat = bmat.reshape(bsz, nc, q, g, n)
    cmat = cmat.reshape(bsz, nc, q, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    if pad:
        valid = (torch.arange(seq_p, device=dt.device) < seq).to(f32)
        dt = dt * valid[None, :, None]
    dt = dt.reshape(bsz, nc, q, h)
    a = -torch.exp(p["A_log"])  # (H,)
    la = torch.cumsum(dt * a, dim=2)  # (B, nc, Q, H) log-decay within chunk
    rep = h // g
    # above the diagonal the decay exponent la[t] - la[s] is positive and
    # grows with the chunk; it is masked to -inf before the exp (the
    # reference multiplies exp(...) by the causal mask after it, which
    # overflows to inf * 0 = NaN at full-size chunks)
    upper = torch.ones((q, q), dtype=torch.bool, device=dt.device).triu(1)

    def chunk_step(state, xc, bc, cc, dtc, lac):
        bh = bc.repeat_interleave(rep, dim=2).float()  # (B, Q, H, N)
        ch = cc.repeat_interleave(rep, dim=2).float()
        # intra-chunk dual (quadratic) form
        scores = torch.einsum("bthn,bshn->bhts", ch, bh)  # (B, H, Q, Q)
        seg = (lac[:, :, None, :] - lac[:, None, :, :]).permute(0, 3, 1, 2)
        decay = torch.exp(seg.masked_fill(upper, float("-inf")))  # (B, H, t, s)
        w = scores * decay * dtc.transpose(1, 2)[:, :, None, :]
        xs_f = xc.float()
        y = torch.einsum("bhts,bshp->bthp", w, xs_f)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bthn,bhpn->bthp", ch, state) * torch.exp(lac)[..., None]
        last = lac[:, -1, :]  # (B, H)
        sc = torch.einsum(
            "bshn,bsh,bshp->bhpn", bh, torch.exp(last[:, None, :] - lac) * dtc, xs_f
        )
        return state * torch.exp(last)[:, :, None, None] + sc, y

    remat = FLAGS.ssm_chunk_remat and torch.is_grad_enabled()
    state = torch.zeros((bsz, h, hd, n), dtype=f32, device=x_in.device)
    ys = []
    for c in range(nc):
        blk = (state, xs[:, c], bmat[:, c], cmat[:, c], dt[:, c], la[:, c])
        state, y = (checkpoint(chunk_step, *blk, use_reentrant=False) if remat
                    else chunk_step(*blk))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, seq_p, h, hd)
    y = y + xs.reshape(bsz, seq_p, h, hd).float() * p["D"][:, None]
    y = y.reshape(bsz, seq_p, d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, :seq]
    if not return_state:
        return out
    # decode cache: the raw (pre-conv) xBC tail + the final SSM state
    xbc_raw = xbc_raw[:, :seq]
    km1 = s.d_conv - 1
    if seq >= km1:
        conv_tail = xbc_raw[:, seq - km1 : seq]
    else:
        conv_tail = F.pad(xbc_raw, (0, 0, km1 - seq, 0))
    return out, {"conv": conv_tail.contiguous(), "ssm": state}


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device) -> Cache:
    s, _, h, d_xbc = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    }


def mamba_decode(p, x_in: torch.Tensor, cache: Cache, cfg: ArchConfig) -> Tuple[torch.Tensor, Cache]:
    """x_in (B, 1, D) single step; O(1) state update."""
    s, d_inner, h, _ = _dims(cfg)
    bsz = x_in.shape[0]
    zxbcdt = x_in[:, 0] @ p["in_proj"]  # (B, *)
    z, xbc, dt_raw = _split(cfg, zxbcdt)

    conv_win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    acc = torch.einsum("bkd,kd->bd", conv_win, p["conv_w"]) + p["conv_b"]
    xbc_c = F.silu(acc)
    new_conv = conv_win[:, 1:]

    xs, bmat, cmat = _split_xbc(cfg, xbc_c)
    g, n, hd = s.n_groups, s.d_state, s.head_dim
    xs = xs.reshape(bsz, h, hd).float()
    rep = h // g
    bh = bmat.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    ch = cmat.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)  # (B, H)
    state = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs, bh
    )
    y = torch.einsum("bhn,bhpn->bhp", ch, state)  # (B, H, P)
    y = y + xs * p["D"][:, None]
    y = y.reshape(bsz, d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "ssm": state}
