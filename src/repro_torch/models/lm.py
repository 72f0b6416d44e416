"""Model-level API: init / loss / logits / prefill / decode.

    model = init_lm(cfg, seed=0)                        # on the card
    model = init_lm(cfg, seed=0, device="cpu")          # on the CPU
    loss, metrics = lm_loss(model, batch)               # train step core
    logits = lm_logits(model, tokens)                   # (B, S, vocab)
    logits, state = lm_prefill(model, tokens, max_len)  # last-token logits
    logits, state = lm_decode_step(model, token, pos, state)

`tokens` are int tensors on the model's device.  Embedding tables are
padded to a multiple of 2048 rows; padded logits are cut.  The decode
state is ``{"layers": [cache per layer]}``; caches are updated in place.
Serving runs under `inference_mode`; `lm_loss` is the one entry point
that builds an autograd graph.

Ported: decoder-only stacks of GQA attention (dense SwiGLU MLP) and mamba
layers, with tied or untied heads, and zamba2's shared attention block
with per-invocation LoRA -- the dense configs, mamba2-1.3b and zamba2-7b
among the registered architectures.  MLA, MoE, the encoder-decoder and
MTP raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (
    Params,
    dense_init,
    embed_init,
    pad_vocab,
    rms_norm,
    softmax_cross_entropy,
)

State = Dict[str, List[Dict[str, torch.Tensor]]]


class LM(Params):
    """A language model's parameters (`embed`, `layers` -- one `Params`
    per layer, in stack order --, `final_norm`, `lm_head` when untied,
    `shared` -- zamba2's shared attention and MLP -- when the config has
    a shared-attention period) with its config and the per-layer specs of
    its stack plan."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        layers = tree["layers"]
        super().__init__({k: v for k, v in tree.items() if k != "layers"})
        self.cfg = cfg
        plan = blocks.build_stack_plan(cfg)
        self.specs = blocks.plan_layer_specs(plan)
        self.spans = blocks.super_block_spans(plan)
        if len(layers) != len(self.specs):
            raise ValueError(f"{len(layers)} layers for a plan of {len(self.specs)}")
        self.layers = torch.nn.ModuleList(
            lp if isinstance(lp, Params) else Params(lp) for lp in layers
        )
        if bool(cfg.shared_attn_period) != ("shared" in self):
            raise ValueError(f"{cfg.name}: a shared block goes with a shared-attention period")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def shared_block(self) -> Optional[Params]:
        """The shared attention + MLP (zamba2), else None."""
        return self["shared"] if "shared" in self else None


def init_lm(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> LM:
    """Random weights from `seed`, drawn on `device` (cuda unless the
    caller names another): the reference's initialisers' distributions,
    in `cfg.dtype`.  The same seed gives other numbers than JAX's; tests
    that compare with the reference load its weights with `from_jax`."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vpad = pad_vocab(cfg.vocab_size)
    specs = blocks.plan_layer_specs(blocks.build_stack_plan(cfg))
    tree = {
        "embed": embed_init(gen, (vpad, cfg.d_model), dtype, dev),
        "layers": [blocks.init_layer(gen, s, cfg, dtype, dev) for s in specs],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (cfg.d_model, vpad), dtype, dev)
    if cfg.shared_attn_period:
        tree["shared"] = blocks.init_shared(gen, cfg, dtype, dev)
    return LM(cfg, tree)


def _positions(bsz: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(bsz, s)


def _head(model: LM, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    h = rms_norm(x, model.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ model.embed.T
    else:
        logits = h @ model.lm_head
    return logits[..., : cfg.vocab_size]


def lm_loss(
    model: LM, batch: Dict[str, torch.Tensor], *, remat: bool = True
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token NLL of `batch` (``tokens``, ``targets`` (B, S) int, optional
    ``mask``) and the reference's metrics (``nll``, ``moe_aux``, ``moe_z``,
    ``loss``; the MoE terms are 0 for the ported families).  With `remat`
    each super-block's activations are recomputed in the backward."""
    tokens, targets = batch["tokens"], batch["targets"]
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    x = blocks.apply_stack(
        model.layers, model.specs, model.spans, model.cfg, x, pos, model.shared_block,
        remat=remat,
    )
    nll = softmax_cross_entropy(_head(model, x), targets, batch.get("mask"))
    zero = torch.zeros((), dtype=torch.float32, device=nll.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    loss = nll + aux["moe_aux"] + aux["moe_z"]
    return loss, {"nll": nll, **aux, "loss": loss}


@torch.inference_mode()
def lm_logits(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab)."""
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    for spec, lp in zip(model.specs, model.layers):
        x, _ = blocks.apply_layer(lp, spec, model.cfg, x, pos, model.shared_block)
    return _head(model, x)


@torch.inference_mode()
def lm_prefill(model: LM, tokens: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, State]:
    """Run the prompt (B, S), build the caches.  Returns (last-token
    logits (B, vocab), state)."""
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    caches = []
    for spec, lp in zip(model.specs, model.layers):
        x, cache = blocks.apply_layer(
            lp, spec, model.cfg, x, pos, model.shared_block, build_cache_len=max_len
        )
        caches.append(cache)
    return _head(model, x[:, -1:])[:, 0], {"layers": caches}


@torch.inference_mode()
def lm_decode_step(
    model: LM, token: torch.Tensor, pos: int, state: State
) -> Tuple[torch.Tensor, State]:
    """One decode step: `token` (B,) at position `pos`.  Returns (logits
    (B, vocab), state)."""
    x = model.embed[token[:, None]]
    caches = []
    for spec, lp, cache in zip(model.specs, model.layers, state["layers"]):
        x, cache = blocks.apply_layer_decode(
            lp, spec, model.cfg, x, pos, cache, model.shared_block)
        caches.append(cache)
    return _head(model, x)[:, 0], {"layers": caches}
