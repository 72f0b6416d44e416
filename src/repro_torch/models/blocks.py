"""Layer and stack assembly.

A model stack is a sequence of *groups*; each group repeats `n_repeat`
identical *super-blocks*; a super-block is a short static tuple of
`LayerSpec`s.  The plan is the reference's (`build_stack_plan`) for the
ported stacks: dense LMs are one group of 1-layer super-blocks, gemma3 is
super-blocks of 5 local + 1 global attention layers plus a tail group,
mamba2 is one group of mamba layers.  Where the reference scans over
stacked layer weights, the port walks a flat list of per-layer modules
(`plan_layer_specs` gives each layer's spec, in the same order).
`apply_stack` runs the full-sequence stack for training; with `remat`
each super-block runs under `torch.utils.checkpoint` (the reference's
`jax.checkpoint(body)` over one scan step), so the backward recomputes
a super-block's activations instead of storing them.

Ported mixers: GQA attention ("attn") and "mamba", each layer with its
dense MLP where the spec has one.  Architectures with MLA, MoE, zamba2's
shared attention, an encoder-decoder or an MTP head raise
NotImplementedError when their plan is built, naming the ROADMAP item
that ports them.
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
from repro_torch.models.common import rms_norm

NOT_PORTED = "ROADMAP §1, the remaining LM families"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "mamba"
    window: int = 0  # 0 = global
    has_mlp: bool = True  # mamba blocks carry no MLP


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    n_repeat: int
    layers: Tuple[LayerSpec, ...]


def check_ported(cfg: ArchConfig) -> None:
    """Raise for an architecture whose layers or heads are not ported."""
    missing = [name for name, present in (
        ("MLA", cfg.mla), ("MoE", cfg.moe), ("shared attention", cfg.shared_attn_period),
        ("encoder-decoder", cfg.is_encoder_decoder), ("MTP", cfg.mtp),
    ) if present]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported: {NOT_PORTED}"
        )


def build_stack_plan(cfg: ArchConfig) -> Tuple[GroupSpec, ...]:
    check_ported(cfg)
    n = cfg.n_layers
    if cfg.family == "ssm":
        return (GroupSpec(n, (LayerSpec(mixer="mamba", has_mlp=False),)),)

    if cfg.local_global_period:  # gemma3-style 5:1 local:global
        p = cfg.local_global_period
        local = LayerSpec(mixer="attn", window=cfg.sliding_window)
        glob = LayerSpec(mixer="attn", window=0)
        full, rem = divmod(n, p)
        groups = []
        if full:
            groups.append(GroupSpec(full, (local,) * (p - 1) + (glob,)))
        if rem:
            groups.append(GroupSpec(1, (local,) * rem))
        return tuple(groups)

    return (GroupSpec(n, (LayerSpec(mixer="attn"),)),)


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
    else:
        p["mamba"] = mamba_mod.init_mamba(gen, cfg, dtype, device)
    if spec.has_mlp:
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
        p["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def apply_layer(
    p,
    spec: LayerSpec,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    build_cache_len: Optional[int] = None,
):
    """Full-sequence layer application (prefill).  Returns (x, cache or
    None); the cache is built when `build_cache_len` is given."""
    cache = None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        if build_cache_len is not None:
            y, (k, v) = attn_mod.attn_forward(
                p["attn"], h, positions, cfg, window=spec.window, return_kv=True
            )
            cache = attn_mod.init_kv_cache(
                cfg, x.shape[0], build_cache_len, spec.window, x.dtype, x.device
            )
            cache = attn_mod.fill_kv_cache(cache, k, v, positions)
        else:
            y = attn_mod.attn_forward(p["attn"], h, positions, cfg, window=spec.window)
    elif build_cache_len is not None:
        y, cache = mamba_mod.mamba_forward(p["mamba"], h, cfg, return_state=True)
    else:
        y = mamba_mod.mamba_forward(p["mamba"], h, cfg)
    x = x + y
    if spec.has_mlp:
        x = x + mlp_mod.mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache


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
    *,
    remat: bool = False,
) -> torch.Tensor:
    """The full-sequence stack (training): every layer in order; with
    `remat`, one `checkpoint(..., use_reentrant=False)` per super-block."""
    for start, n in spans:
        def body(x, start=start, n=n):
            for i in range(start, start + n):
                x, _ = apply_layer(layers[i], specs[i], cfg, x, positions)
            return x

        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return x


def apply_layer_decode(
    p,
    spec: LayerSpec,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, D)
    pos: int,
    cache: Dict[str, torch.Tensor],
):
    """One decode step of one layer.  Returns (x, new cache); the dense
    MLP is the fused decode-MLP kernel on the card."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        y, cache = attn_mod.attn_decode(p["attn"], h, pos, cache, cfg, window=spec.window)
    else:
        y, cache = mamba_mod.mamba_decode(p["mamba"], h, cache, cfg)
    x = x + y
    if spec.has_mlp:
        x = x + mlp_mod.mlp_decode(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache
