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

Ported: decoder-only stacks of GQA attention or MLA (dense SwiGLU MLP or
a mixture of experts) and mamba layers, with tied or untied heads,
zamba2's shared attention block with per-invocation LoRA, and
DeepSeek-V3's multi-token-prediction head (`mtp`, trained by `lm_loss`,
never served) -- every registered architecture but the encoder-decoder
(seamless-m4t-medium), which raises NotImplementedError.
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

# the MTP head's block: one GQA attention layer with a dense MLP, at the
# config's own head dim (d_model // n_heads: 56 for deepseek-v3-671b)
MTP_SPEC = blocks.LayerSpec(mixer="attn")
MTP_WEIGHT = 0.3  # the MTP loss's weight in the total


class LM(Params):
    """A language model's parameters (`embed`, `layers` -- one `Params`
    per layer, in stack order --, `final_norm`, `lm_head` when untied,
    `shared` -- zamba2's shared attention and MLP -- when the config has
    a shared-attention period, `mtp` -- DeepSeek-V3's MTP head: `proj`,
    `norm_h`, `norm_e` and an attention `block` -- when the config has
    one) with its config and the per-layer specs of its stack plan."""

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
        if bool(cfg.mtp) != ("mtp" in self):
            raise ValueError(f"{cfg.name}: an MTP head goes with `mtp` in the config")

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
    if cfg.mtp:
        tree["mtp"] = {
            "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype, dev),
            "norm_h": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "norm_e": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "block": blocks.init_layer(gen, MTP_SPEC, cfg, dtype, dev),
        }
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
    ``mask``) plus the MoE aux losses summed over the stack, and the
    reference's metrics (``nll``, ``moe_aux``, ``moe_z``, ``loss``; the
    MoE terms are 0 without experts).  With `remat` each super-block's
    activations are recomputed in the backward (the MTP head's block is
    not, as in the reference).

    With an MTP head (DeepSeek-V3) the loss adds 0.3 x ``mtp_nll``, the
    NLL of predicting token t + 2: the stack's output at t (``norm_h``)
    and the embedded target at t (``norm_e``) are concatenated, projected
    (``proj``), run through the head's attention block at positions 0..S-2
    and the shared output head, against ``targets`` shifted by one (the
    mask too)."""
    cfg = model.cfg
    tokens, targets = batch["tokens"], batch["targets"]
    mask = batch.get("mask")
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    x, aux = blocks.apply_stack(
        model.layers, model.specs, model.spans, cfg, x, pos, model.shared_block,
        remat=remat,
    )
    nll = softmax_cross_entropy(_head(model, x), targets, mask)
    loss = nll + aux["moe_aux"] + aux["moe_z"]
    metrics = {"nll": nll, **aux}
    if cfg.mtp:
        mp = model["mtp"]
        h_in = rms_norm(x[:, :-1], mp.norm_h, cfg.norm_eps)
        e_in = rms_norm(model.embed[targets[:, :-1]], mp.norm_e, cfg.norm_eps)
        z = torch.cat([h_in, e_in], dim=-1) @ mp.proj
        z, _, _ = blocks.apply_layer(mp.block, MTP_SPEC, cfg, z, pos[:, :-1])
        mtp_nll = softmax_cross_entropy(
            _head(model, z), targets[:, 1:], None if mask is None else mask[:, 1:])
        loss = loss + MTP_WEIGHT * mtp_nll
        metrics["mtp_nll"] = mtp_nll
    return loss, {**metrics, "loss": loss}


@torch.inference_mode()
def lm_logits(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab)."""
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    for spec, lp in zip(model.specs, model.layers):
        x, _, _ = blocks.apply_layer(lp, spec, model.cfg, x, pos, model.shared_block)
    return _head(model, x)


@torch.inference_mode()
def lm_prefill(model: LM, tokens: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, State]:
    """Run the prompt (B, S), build the caches.  Returns (last-token
    logits (B, vocab), state)."""
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    caches = []
    for spec, lp in zip(model.specs, model.layers):
        x, _, cache = blocks.apply_layer(
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
