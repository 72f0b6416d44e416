"""Model-level API: init / logits / prefill / decode.

    model = init_lm(cfg, seed=0)                        # on the card
    model = init_lm(cfg, seed=0, device="cpu")          # on the CPU
    logits = lm_logits(model, tokens)                   # (B, S, vocab)
    logits, state = lm_prefill(model, tokens, max_len)  # last-token logits
    logits, state = lm_decode_step(model, token, pos, state)

`tokens` are int tensors on the model's device.  Embedding tables are
padded to a multiple of 2048 rows; padded logits are cut.  The decode
state is ``{"layers": [cache per layer]}``; caches are updated in place.

Ported: decoder-only stacks of GQA attention (dense SwiGLU MLP) and mamba
layers, with tied or untied heads -- gemma3-1b and mamba2-1.3b, among
the registered architectures.  The rest raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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
)

State = Dict[str, List[Dict[str, torch.Tensor]]]


class LM(Params):
    """A language model's parameters (`embed`, `layers` -- one `Params`
    per layer, in stack order --, `final_norm`, `lm_head` when untied)
    with its config and the per-layer specs of its stack plan."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        layers = tree["layers"]
        super().__init__({k: v for k, v in tree.items() if k != "layers"})
        self.cfg = cfg
        self.specs = blocks.plan_layer_specs(blocks.build_stack_plan(cfg))
        if len(layers) != len(self.specs):
            raise ValueError(f"{len(layers)} layers for a plan of {len(self.specs)}")
        self.layers = torch.nn.ModuleList(
            lp if isinstance(lp, Params) else Params(lp) for lp in layers
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device


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


@torch.inference_mode()
def lm_logits(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab)."""
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    for spec, lp in zip(model.specs, model.layers):
        x, _ = blocks.apply_layer(lp, spec, model.cfg, x, pos)
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
            lp, spec, model.cfg, x, pos, build_cache_len=max_len
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
        x, cache = blocks.apply_layer_decode(lp, spec, model.cfg, x, pos, cache)
        caches.append(cache)
    return _head(model, x)[:, 0], {"layers": caches}
