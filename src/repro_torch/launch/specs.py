"""Meta-device stand-ins for every model input (the dry run's entry points).

Nothing is allocated here: parameters, optimizer state and caches are the
real init functions run on the meta device (`init_lm`, `train_state`,
`init_decode_state` with ``device="meta"``), inputs are meta tensors of
the reference's shapes and dtypes.  The port's stack holds one
parameter tree per layer where the reference stacks each group's
repeats; `reference_layout` and `reference_cache_layout` give the
sharding builders the reference's stacked layout of the same leaves
(meta tensors, the reference's key paths), so the rules see the shapes
the reference's rules see.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Mapping

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import blocks
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainConfig, make_train_step, train_state

META = torch.device("meta")

# speech/vision frontend stub: precomputed frame/patch embedding length used
# for the encoder side of enc-dec cells
SRC_FRAMES = 1024


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of `shape` and `dtype` (a torch dtype or its name)."""
    return torch.empty(shape, dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
                       device=META)


def train_config_for(cfg: ArchConfig) -> TrainConfig:
    """Full-scale training config per arch (moment precision scales down as
    the model scales up)."""
    approx_params = cfg.n_layers * cfg.d_model * cfg.d_model
    if cfg.moe:
        approx_params = (
            cfg.n_layers * cfg.moe.n_experts * 3 * cfg.d_model * cfg.d_ff
        )
    if approx_params > 2e11:
        moment = "int8"
    elif approx_params > 5e9:
        moment = "bfloat16"
    else:
        moment = "float32"
    return TrainConfig(optimizer=AdamWConfig(moment_dtype=moment), remat=True)


def param_shapes(cfg: ArchConfig) -> lm_mod.LM:
    """The model on the meta device: every leaf's name, shape and dtype."""
    return lm_mod.init_lm(cfg, device=META)


def train_state_shapes(cfg: ArchConfig, tcfg: TrainConfig) -> Dict:
    """The train state on the meta device: params, moments, counts."""
    return train_state(param_shapes(cfg), tcfg)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Training batch stand-ins."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        # split the budget: src frames + tgt tokens of s/2 each
        return {
            "src_embeds": sds((b, s // 2, cfg.d_model), cfg.dtype),
            "tokens": sds((b, s // 2), torch.int32),
            "targets": sds((b, s // 2), torch.int32),
            "mask": sds((b, s // 2), torch.float32),
        }
    return {
        "tokens": sds((b, s), torch.int32),
        "targets": sds((b, s), torch.int32),
        "mask": sds((b, s), torch.float32),
    }


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {
            "src_embeds": sds((b, s, cfg.d_model), cfg.dtype),
            "tokens": sds((b, 128), torch.int32),  # short decoder prompt
        }
    return {"tokens": sds((b, s), torch.int32)}


def decode_state_shapes(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    b, s = shape.global_batch, shape.seq_len
    return lm_mod.init_decode_state(cfg, b, s, src_len=SRC_FRAMES, device=META)


def decode_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    return {
        "token": sds((b,), torch.int32),
        "pos": sds((), torch.int32),
    }


# ---------------------------------------------------------------------------
# the functions the dry run runs under its op counter
# ---------------------------------------------------------------------------


def train_fn(cfg: ArchConfig, tcfg: TrainConfig):
    return make_train_step(cfg, tcfg)


def prefill_fn(cfg: ArchConfig, shape: ShapeConfig):
    """Plain `lm_prefill` to the cell's length.  The reference's
    context-parallel prefill (for head counts that do not divide the model
    axis) needs its runtime flags and a model axis, and the port has
    neither: one card prefills every arch the same way."""

    def fn(model, batch):
        kw = {}
        if cfg.is_encoder_decoder:
            kw["src_embeds"] = batch["src_embeds"]
        return lm_mod.lm_prefill(model, batch["tokens"], shape.seq_len, **kw)

    return fn


def decode_fn(cfg: ArchConfig):
    """One decode step.  `pos` is a Python int, the position the step
    writes: the reference traces it as a scalar; no op of the port's step
    depends on its value (every cache slot is read, masked by position),
    so the dry run passes the cache's last slot."""

    def fn(model, token, pos: int, state):
        return lm_mod.lm_decode_step(model, token, pos, state)

    return fn


# ---------------------------------------------------------------------------
# the reference's stacked layout, for the sharding builders
# ---------------------------------------------------------------------------


def _meta_like(leaf, n: int = 0):
    """A meta stand-in of `leaf` (a tensor, or a mapping of them: an int8
    moment), with a leading dim of `n` stacked layers when n > 0."""
    if isinstance(leaf, Mapping):
        return {k: _meta_like(v, n) for k, v in leaf.items()}
    shape = ((n,) if n else ()) + tuple(leaf.shape)
    return torch.empty(shape, dtype=leaf.dtype, device=META)


def _put(tree: Dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _slots(cfg: ArchConfig, stack: str):
    """flat layer index -> (group, repeat, position, repeats) of a plan."""
    out = []
    for g, gspec in enumerate(blocks.build_stack_plan(cfg, stack)):
        for r in range(gspec.n_repeat):
            for i in range(len(gspec.layers)):
                out.append((g, r, i, gspec.n_repeat))
    return out


def reference_layout(named: Mapping[str, Any], cfg: ArchConfig) -> Dict:
    """{a parameter's dotted name (`named_parameters`): leaf} -> the
    reference's parameter tree of meta stand-ins: ``stack/<g>/layers/<i>``
    (an encoder's under ``encoder/``) with each group's repeats stacked on
    a leading dim, the model-level leaves (`embed`, `shared`, `mtp`, ...)
    as they are.  Moments keyed by parameter name map the same way."""
    slots = {"": _slots(cfg, "decoder")}
    if cfg.is_encoder_decoder:
        slots["encoder"] = _slots(cfg, "encoder")
    stacked = defaultdict(list)
    out: Dict = {}
    for name, leaf in named.items():
        parts = name.split(".")
        pre = ["encoder"] if parts[0] == "encoder" and parts[1] == "layers" else []
        if parts[len(pre)] == "layers":
            g, r, i, n = slots["/".join(pre)][int(parts[len(pre) + 1])]
            path = (*pre, "stack", str(g), "layers", str(i), *parts[len(pre) + 2:])
            stacked[path].append((r, n, leaf))
        else:
            _put(out, parts, _meta_like(leaf))
    for path, items in stacked.items():
        items.sort(key=lambda it: it[0])
        _put(out, path, _meta_like(items[0][2], items[0][1]))
    return out


def reference_cache_layout(state: Mapping[str, Any], cfg: ArchConfig) -> Dict:
    """The port's decode state -> the reference's: ``groups/<g>/<i>/self``
    with each group's repeats stacked, ``cross_x`` / ``cross_pos`` as they
    are."""
    out: Dict = {k: _meta_like(v) for k, v in state.items() if k != "layers"}
    seen = set()
    for (g, _, i, n), cache in zip(_slots(cfg, "decoder"), state["layers"]):
        if (g, i) not in seen:
            seen.add((g, i))
            _put(out, ("groups", str(g), str(i), "self"), _meta_like(cache, n))
    return out
