"""Layer and stack assembly.

A model stack is a sequence of *groups*; each group repeats `n_repeat`
identical *super-blocks*; a super-block is a short static tuple of
`LayerSpec`s.  The plan is the reference's (`build_stack_plan`) for the
ported stacks: dense LMs are one group of 1-layer super-blocks, gemma3 is
super-blocks of 5 local + 1 global attention layers plus a tail group,
mamba2 is one group of mamba layers, zamba2 is super-blocks of one
shared-attention invocation + `period` mamba layers plus a tail group of
mamba layers, an encoder-decoder is an encoder stack and a decoder stack
with cross attention.  Where the reference scans over
stacked layer weights, the port walks a flat list of per-layer modules
(`plan_layer_specs` gives each layer's spec, in the same order).
`apply_stack` runs the full-sequence stack for training and returns the
MoE aux losses summed over its layers (the reference's `apply_group`);
with `remat` each super-block runs under `torch.utils.checkpoint` (the
reference's `jax.checkpoint(body)` over one scan step), so the backward
recomputes a super-block's activations instead of storing them.

Ported mixers: GQA attention ("attn"), DeepSeek-V3's latent attention
("mla", `attention.mla_forward`; its cache holds the latents and its
decode is the absorbed form), "mamba", and zamba2's
"shared_attn": one attention block and one dense MLP whose weights live
at model level (`shared`, ``{"attn": ..., "mlp": ...}``), invoked every
`period` layers with the invocation's own norms and low-rank q / k / v
deltas (``lora_{q,k,v}_{a,b}``, merged into the shared attention's
weights per call).  Each layer has its dense MLP where the spec has one,
or its mixture of experts (`models/moe.py`) where the spec sets `moe`:
the dense-family plan does for an MoE config (moonshot-v1-16b-a3b), and
the decode step calls the same `moe_forward` on its (B, 1, D) input.
Under `remat` the shared weights are closure inputs of every
super-block's checkpointed body (`use_reentrant=False` differentiates
those too), so their gradient sums over the invocations.

The encoder-decoder (seamless-m4t-medium) has two plans: the encoder's
(`role="encoder"`, one group of bidirectional attention layers, spec
`causal=False`) and the decoder's, whose layers set `cross_attn`: after
the mixer each adds ``x + attn(ln_cross(x), cross_x)``, its own
attention weights (``cross``) over the encoder's output `cross_x`, in
prefill, decode and training alike.  (The encoder's weights and
DeepSeek-V3's MTP head are model-level: `lm.init_lm` builds them,
`lm._encode` and `lm.lm_loss` run them.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import rms_norm


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "mla" | "mamba" | "shared_attn"
    window: int = 0  # 0 = global
    moe: bool = False  # the MLP is a mixture of experts
    has_mlp: bool = True  # mamba blocks carry no MLP
    cross_attn: bool = False  # decoder-side cross attention (encoder-decoder)
    causal: bool = True  # encoder layers are bidirectional


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    n_repeat: int
    layers: Tuple[LayerSpec, ...]


def build_stack_plan(cfg: ArchConfig, role: str = "decoder") -> Tuple[GroupSpec, ...]:
    """The stack's groups; `role="encoder"` gives an encoder-decoder's
    encoder (one group of bidirectional attention layers)."""
    if role == "encoder":
        return (GroupSpec(cfg.encoder_layers, (LayerSpec(mixer="attn", causal=False),)),)
    n = cfg.n_layers
    if cfg.family == "ssm":
        return (GroupSpec(n, (LayerSpec(mixer="mamba", has_mlp=False),)),)

    if cfg.shared_attn_period:  # zamba2: [shared attn, period x mamba] + tail
        p = cfg.shared_attn_period
        mamba = LayerSpec(mixer="mamba", has_mlp=False)
        full, rem = divmod(n, p)
        groups = []
        if full:
            groups.append(GroupSpec(full, (LayerSpec(mixer="shared_attn"),) + (mamba,) * p))
        if rem:
            groups.append(GroupSpec(1, (mamba,) * rem))
        return tuple(groups)

    if cfg.local_global_period:  # gemma3-style 5:1 local:global
        p = cfg.local_global_period
        local = LayerSpec(mixer="attn", window=cfg.sliding_window, moe=bool(cfg.moe))
        glob = LayerSpec(mixer="attn", window=0, moe=bool(cfg.moe))
        full, rem = divmod(n, p)
        groups = []
        if full:
            groups.append(GroupSpec(full, (local,) * (p - 1) + (glob,)))
        if rem:
            groups.append(GroupSpec(1, (local,) * rem))
        return tuple(groups)

    mixer = "mla" if cfg.mla else "attn"
    spec = LayerSpec(mixer=mixer, moe=bool(cfg.moe), cross_attn=cfg.is_encoder_decoder)
    return (GroupSpec(n, (spec,)),)


def plan_layer_specs(plan: Tuple[GroupSpec, ...]) -> Tuple[LayerSpec, ...]:
    """Flattened per-layer specs, in stack order."""
    out = []
    for g in plan:
        for _ in range(g.n_repeat):
            out.extend(g.layers)
    return tuple(out)


# ---------------------------------------------------------------------------
# single-layer init / apply
# ---------------------------------------------------------------------------


def init_layer(gen, spec: LayerSpec, cfg: ArchConfig, dtype, device) -> Dict:
    d = cfg.d_model
    p: Dict = {"ln1": torch.zeros((d,), dtype=dtype, device=device)}
    if spec.mixer == "attn":
        p["attn"] = attn_mod.init_attn(gen, cfg, dtype, device)
    elif spec.mixer == "mla":
        p["attn"] = attn_mod.init_mla(gen, cfg, dtype, device)
    elif spec.mixer == "mamba":
        p["mamba"] = mamba_mod.init_mamba(gen, cfg, dtype, device)
    elif spec.mixer == "shared_attn":
        # the weights are model-level (`init_shared`); the invocation's
        # LoRA and norms live here, and it carries no MLP of its own
        rank = max(1, cfg.shared_attn_lora_rank)
        p.update(attn_mod.init_lora(gen, cfg, rank, dtype, device))
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        p["ln_cross"] = torch.zeros((d,), dtype=dtype, device=device)
        p["cross"] = attn_mod.init_attn(gen, cfg, dtype, device)
    if spec.has_mlp:
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
        if spec.moe:
            p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
        elif spec.mixer != "shared_attn":
            p["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_shared(gen, cfg: ArchConfig, dtype, device) -> Dict:
    """zamba2's model-level shared block: one attention's and one dense
    MLP's weights."""
    return {
        "attn": attn_mod.init_attn(gen, cfg, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _merge_shared_attn(shared, p) -> Dict[str, torch.Tensor]:
    """The shared attention's weights with this invocation's LoRA leaves."""
    merged = dict(shared["attn"].named_parameters())
    merged.update((k, v) for k, v in p.named_parameters() if k.startswith("lora_"))
    return merged


def _mlp_params(p, spec: LayerSpec, shared):
    return shared["mlp"] if spec.mixer == "shared_attn" else p["mlp"]


def apply_layer(
    p,
    spec: LayerSpec,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    shared=None,
    *,
    cross_x: Optional[torch.Tensor] = None,
    build_cache_len: Optional[int] = None,
    cache_dtype: Optional[torch.dtype] = None,
):
    """Full-sequence layer application (training, prefill, the encoder).
    Returns (x, aux, cache): the MoE aux losses ({moe_aux, moe_z}) where
    the spec has experts, else None; the cache (or None) is built when
    `build_cache_len` is given, an attention cache in `cache_dtype` (x's
    dtype by default; `lm_prefill` passes the config's, as the
    reference).  `shared` is the model's shared block (zamba2), read by
    "shared_attn" layers; `cross_x` the encoder's output, read by a layer
    with `cross_attn`."""
    cache = aux = None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer in ("attn", "shared_attn"):
        ap = _merge_shared_attn(shared, p) if spec.mixer == "shared_attn" else p["attn"]
        if build_cache_len is not None:
            y, (k, v) = attn_mod.attn_forward(
                ap, h, positions, cfg, window=spec.window, causal=spec.causal, return_kv=True
            )
            cache = attn_mod.init_kv_cache(
                cfg, x.shape[0], build_cache_len, spec.window, cache_dtype or x.dtype, x.device
            )
            cache = attn_mod.fill_kv_cache(cache, k, v, positions)
        else:
            y = attn_mod.attn_forward(
                ap, h, positions, cfg, window=spec.window, causal=spec.causal)
    elif spec.mixer == "mla":
        if build_cache_len is not None:
            y, (c_kv, k_rope) = attn_mod.mla_forward(
                p["attn"], h, positions, cfg, return_latent=True)
            cache = attn_mod.init_mla_cache(cfg, x.shape[0], build_cache_len,
                                            cache_dtype or x.dtype, x.device)
            cache = attn_mod.fill_mla_cache(cache, c_kv, k_rope, positions)
        else:
            y = attn_mod.mla_forward(p["attn"], h, positions, cfg)
    elif build_cache_len is not None:
        y, cache = mamba_mod.mamba_forward(p["mamba"], h, cfg, return_state=True)
    else:
        y = mamba_mod.mamba_forward(p["mamba"], h, cfg)
    x = x + y
    if spec.cross_attn:
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = x + attn_mod.attn_forward(p["cross"], h, positions, cfg, cross_x=cross_x)
    if spec.has_mlp:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            y, aux = moe_mod.moe_forward(p["moe"], h, cfg)
        else:
            y = mlp_mod.mlp_forward(_mlp_params(p, spec, shared), h)
        x = x + y
    return x, aux, cache


def init_layer_cache(spec: LayerSpec, cfg: ArchConfig, batch: int, max_len: int, dtype,
                     device):
    """A layer's empty decode cache at capacity `max_len`, laid out as
    `apply_layer` builds it: k / v / pos (a ring of the window's length
    for a windowed layer), MLA's c_kv / k_rope / pos, or mamba's conv and
    f32 SSD state."""
    if spec.mixer in ("attn", "shared_attn"):
        return attn_mod.init_kv_cache(cfg, batch, max_len, spec.window, dtype, device)
    if spec.mixer == "mla":
        return attn_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    if spec.mixer == "mamba":
        return mamba_mod.init_mamba_cache(cfg, batch, dtype, device)
    raise ValueError(spec.mixer)


def super_block_spans(plan: Tuple[GroupSpec, ...]) -> Tuple[Tuple[int, int], ...]:
    """(first layer, layer count) of each super-block, in stack order."""
    spans, start = [], 0
    for g in plan:
        for _ in range(g.n_repeat):
            spans.append((start, len(g.layers)))
            start += len(g.layers)
    return tuple(spans)


def apply_stack(
    layers,
    specs: Tuple[LayerSpec, ...],
    spans: Tuple[Tuple[int, int], ...],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    shared=None,
    *,
    cross_x: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence stack (training): every layer in order; with
    `remat`, one `checkpoint(..., use_reentrant=False)` per super-block.
    `shared` (zamba2's shared block) is a closure input of every body;
    `cross_x` (the encoder's output) an input of every body, so the
    backward recomputes a cross attention from it.  Returns (x,
    {moe_aux, moe_z}), the aux losses summed over the MoE layers (zeros
    without any), carried through each body."""
    aux = z = torch.zeros((), dtype=torch.float32, device=x.device)
    for start, n in spans:
        def body(x, aux, z, cross_x, start=start, n=n):
            for i in range(start, start + n):
                x, a, _ = apply_layer(layers[i], specs[i], cfg, x, positions, shared,
                                      cross_x=cross_x)
                if a is not None:
                    aux, z = aux + a["moe_aux"], z + a["moe_z"]
            return x, aux, z

        x, aux, z = (checkpoint(body, x, aux, z, cross_x, use_reentrant=False) if remat
                     else body(x, aux, z, cross_x))
    return x, {"moe_aux": aux, "moe_z": z}


def apply_layer_decode(
    p,
    spec: LayerSpec,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, D)
    pos: int,
    cache: Dict[str, torch.Tensor],
    shared=None,
    *,
    cross_x: Optional[torch.Tensor] = None,
):
    """One decode step of one layer.  Returns (x, new cache); the dense
    MLP (zamba2's shared one too) is the fused decode-MLP kernel on the
    card; experts run `moe_forward` on the step's (B, 1, D), as the
    reference does (its aux losses are dropped).  A cross attention runs
    `attn_forward` at Sq 1 over all of `cross_x` (the flash kernel on the
    card), its k and v projected again every step, as the reference
    does."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer in ("attn", "shared_attn"):
        ap = _merge_shared_attn(shared, p) if spec.mixer == "shared_attn" else p["attn"]
        y, cache = attn_mod.attn_decode(ap, h, pos, cache, cfg, window=spec.window)
    elif spec.mixer == "mla":
        y, cache = attn_mod.mla_decode(p["attn"], h, pos, cache, cfg)
    else:
        y, cache = mamba_mod.mamba_decode(p["mamba"], h, cache, cfg)
    x = x + y
    if spec.cross_attn:
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        # no rotary and no mask: cross attention reads no position
        x = x + attn_mod.attn_forward(p["cross"], h, None, cfg, cross_x=cross_x)
    if spec.has_mlp:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            y, _ = moe_mod.moe_forward(p["moe"], h, cfg)
        else:
            y = mlp_mod.mlp_decode(_mlp_params(p, spec, shared), h)
        x = x + y
    return x, cache
