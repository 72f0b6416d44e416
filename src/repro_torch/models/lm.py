"""Model-level API: init / loss / logits / prefill / decode.

    model = init_lm(cfg, seed=0)                        # on the card
    model = init_lm(cfg, seed=0, device="cpu")          # on the CPU
    loss, metrics = lm_loss(model, batch)               # train step core
    logits = lm_logits(model, tokens)                   # (B, S, vocab)
    logits, state = lm_prefill(model, tokens, max_len)  # last-token logits
    logits, state = lm_decode_step(model, token, pos, state)
    state = init_decode_state(cfg, batch, max_len)      # empty caches

`tokens` are int tensors on the model's device.  Embedding tables are
padded to a multiple of 2048 rows; padded logits are cut.  The decode
state is ``{"layers": [cache per layer]}``; caches are updated in place.
Serving runs under `inference_mode`, and under `f32_accumulation`: bf16
products are summed in f32 on the card whatever the caller's cuBLAS
setting; `lm_loss` is the one entry point that builds an autograd graph.

Every registered architecture is ported: decoder-only stacks of GQA
attention or MLA (dense SwiGLU MLP or a mixture of experts) and mamba
layers, with tied or untied heads, zamba2's shared attention block with
per-invocation LoRA, DeepSeek-V3's multi-token-prediction head (`mtp`,
trained by `lm_loss`, never served), and the encoder-decoder
(seamless-m4t-medium).  An encoder-decoder takes source frame embeddings
(B, S_src, d_model) -- the reference's speech frontend is a stub that
provides them -- as ``src_embeds``: a keyword of `lm_logits` and
`lm_prefill`, a key of `lm_loss`'s batch.  Its encoder (`_encode`) runs
first; the decoder's cross attention reads the encoder's output, which
the prefill state carries to every decode step as ``cross_x`` (beside
``cross_pos``, the frames' positions, as the reference's state).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (
    Params,
    dense_init,
    embed_init,
    f32_accumulation,
    pad_vocab,
    rms_norm,
    softmax_cross_entropy,
)

# {"layers": [cache per layer]}, and an encoder-decoder's "cross_x" / "cross_pos"
State = Dict[str, Any]

# the MTP head's block: one GQA attention layer with a dense MLP, at the
# config's own head dim (d_model // n_heads: 56 for deepseek-v3-671b)
MTP_SPEC = blocks.LayerSpec(mixer="attn")
MTP_WEIGHT = 0.3  # the MTP loss's weight in the total


def _stack(layers, n: int) -> torch.nn.ModuleList:
    """One `Params` per layer of a plan of `n` layers."""
    if len(layers) != n:
        raise ValueError(f"{len(layers)} layers for a plan of {n}")
    return torch.nn.ModuleList(lp if isinstance(lp, Params) else Params(lp) for lp in layers)


class LM(Params):
    """A language model's parameters (`embed`, `layers` -- one `Params`
    per layer, in stack order --, `final_norm`, `lm_head` when untied,
    `shared` -- zamba2's shared attention and MLP -- when the config has
    a shared-attention period, `mtp` -- DeepSeek-V3's MTP head: `proj`,
    `norm_h`, `norm_e` and an attention `block` -- when the config has
    one, `encoder` -- an encoder-decoder's encoder: its `layers` and
    `final_norm` -- when the config has encoder layers) with its config
    and the per-layer specs of its stack plans (`enc_specs`: the
    encoder's)."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        tree = dict(tree)
        layers = tree.pop("layers")
        plan = blocks.build_stack_plan(cfg)
        enc_specs = (blocks.plan_layer_specs(blocks.build_stack_plan(cfg, "encoder"))
                     if cfg.is_encoder_decoder else ())
        if cfg.is_encoder_decoder != ("encoder" in tree):
            raise ValueError(f"{cfg.name}: an encoder goes with `encoder_layers` in the config")
        if enc_specs:
            enc = tree["encoder"]
            tree["encoder"] = Params({"final_norm": enc["final_norm"]})
            tree["encoder"].layers = _stack(enc["layers"], len(enc_specs))
        super().__init__(tree)
        self.cfg = cfg
        self.specs = blocks.plan_layer_specs(plan)
        self.spans = blocks.super_block_spans(plan)
        self.enc_specs = enc_specs
        self.layers = _stack(layers, len(self.specs))
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
    that compare with the reference load its weights with `from_jax`.
    On ``device="meta"`` nothing is drawn or allocated: the same modules
    with the same leaf names, shapes and dtypes (the dry run's stand-in)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = None
    if dev.type != "meta":  # a generator on meta raises; it would draw nothing
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
    if cfg.is_encoder_decoder:
        enc_specs = blocks.plan_layer_specs(blocks.build_stack_plan(cfg, "encoder"))
        tree["encoder"] = {
            "layers": [blocks.init_layer(gen, s, cfg, dtype, dev) for s in enc_specs],
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
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


def _encode(model: LM, src_embeds: Optional[torch.Tensor]):
    """The encoder over source frame embeddings (B, S_src, d_model): its
    bidirectional layers (never under remat, as the reference's), then its
    final norm.  Returns (cross_x, cross_pos): the encoder's output and the
    frames' positions 0..S_src-1, which rotate the encoder's q and k.
    Every row's positions are 0..S-1 by construction (`_positions`, here
    and for the decoder's tokens), so the kernels' index masks are the
    reference's position masks."""
    cfg = model.cfg
    if src_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs `src_embeds`, the "
                         "source frame embeddings (B, S_src, d_model)")
    x = src_embeds.to(getattr(torch, cfg.dtype))  # the model's dtype, as the reference
    pos = _positions(x.shape[0], x.shape[1], x.device)
    for spec, lp in zip(model.enc_specs, model.encoder.layers):
        x, _, _ = blocks.apply_layer(lp, spec, cfg, x, pos)
    return rms_norm(x, model.encoder.final_norm, cfg.norm_eps), pos


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
    ``mask``; an encoder-decoder's ``src_embeds`` (B, S_src, d_model)
    float) plus the MoE aux losses summed over the stack, and the
    reference's metrics (``nll``, ``moe_aux``, ``moe_z``, ``loss``; the
    MoE terms are 0 without experts).  With `remat` each super-block's
    activations are recomputed in the backward (the MTP head's block and
    an encoder are not, as in the reference).

    With an MTP head (DeepSeek-V3) the loss adds 0.3 x ``mtp_nll``, the
    NLL of predicting token t + 2: the stack's output at t (``norm_h``)
    and the embedded target at t (``norm_e``) are concatenated, projected
    (``proj``), run through the head's attention block at positions 0..S-2
    and the shared output head, against ``targets`` shifted by one (the
    mask too)."""
    cfg = model.cfg
    tokens, targets = batch["tokens"], batch["targets"]
    mask = batch.get("mask")
    cross_x = _encode(model, batch.get("src_embeds"))[0] if cfg.is_encoder_decoder else None
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    x, aux = blocks.apply_stack(
        model.layers, model.specs, model.spans, cfg, x, pos, model.shared_block,
        cross_x=cross_x, remat=remat,
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
@f32_accumulation()
def lm_logits(
    model: LM, tokens: torch.Tensor, *, src_embeds: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab); an encoder-decoder needs
    `src_embeds`."""
    cross_x = _encode(model, src_embeds)[0] if model.cfg.is_encoder_decoder else None
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    for spec, lp in zip(model.specs, model.layers):
        x, _, _ = blocks.apply_layer(lp, spec, model.cfg, x, pos, model.shared_block,
                                     cross_x=cross_x)
    return _head(model, x)


def init_decode_state(
    cfg: ArchConfig, batch: int, max_len: int, src_len: Optional[int] = None,
    device: DeviceLike = None,
) -> State:
    """Empty decode caches at capacity `max_len` on `device` (cuda unless
    named), laid out exactly as `lm_prefill` lays them out, in the
    config's dtype: one cache per layer of the stack, and an
    encoder-decoder's ``cross_x`` (zeros) / ``cross_pos`` at `src_len`
    frames (1024 by default).  `lm_decode_step` takes it as it takes a
    prefill's state.  On ``device="meta"`` nothing is allocated (the dry
    run's cache shapes)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    specs = blocks.plan_layer_specs(blocks.build_stack_plan(cfg))
    state: State = {}
    if cfg.is_encoder_decoder:
        sl = src_len if src_len is not None else 1024
        state["cross_x"] = torch.zeros((batch, sl, cfg.d_model), dtype=dtype, device=dev)
        state["cross_pos"] = _positions(batch, sl, dev)
    state["layers"] = [blocks.init_layer_cache(s, cfg, batch, max_len, dtype, dev)
                       for s in specs]
    return state


@f32_accumulation()
@torch.inference_mode()
def lm_prefill(
    model: LM, tokens: torch.Tensor, max_len: int, *,
    src_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """Run the prompt (B, S), build the caches; an encoder-decoder runs its
    encoder over `src_embeds` first, and its state carries the encoder's
    output (``cross_x``) and the frames' positions (``cross_pos``).
    Returns (last-token logits (B, vocab), state).  The attention caches
    are in the config's dtype (the reference's `cache_dtype`)."""
    state: State = {}
    cross_x = None
    if model.cfg.is_encoder_decoder:
        cross_x, state["cross_pos"] = _encode(model, src_embeds)
        state["cross_x"] = cross_x
    x = model.embed[tokens]
    pos = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    caches = []
    for spec, lp in zip(model.specs, model.layers):
        x, _, cache = blocks.apply_layer(
            lp, spec, model.cfg, x, pos, model.shared_block, cross_x=cross_x,
            build_cache_len=max_len, cache_dtype=getattr(torch, model.cfg.dtype),
        )
        caches.append(cache)
    state["layers"] = caches
    return _head(model, x[:, -1:])[:, 0], state


@f32_accumulation()
@torch.inference_mode()
def lm_decode_step(
    model: LM, token: torch.Tensor, pos: int, state: State
) -> Tuple[torch.Tensor, State]:
    """One decode step: `token` (B,) at position `pos`.  Returns (logits
    (B, vocab), state)."""
    x = model.embed[token[:, None]]
    cross_x = state.get("cross_x")
    caches = []
    for spec, lp, cache in zip(model.specs, model.layers, state["layers"]):
        x, cache = blocks.apply_layer_decode(
            lp, spec, model.cfg, x, pos, cache, model.shared_block, cross_x=cross_x)
        caches.append(cache)
    return _head(model, x)[:, 0], {**state, "layers": caches}
