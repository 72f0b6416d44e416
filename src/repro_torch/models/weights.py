"""Load the reference's LM parameters into the port.

`from_jax(params, cfg)` takes the pytree that the reference's `init_lm`
returns -- as numpy arrays or anything `numpy.asarray` reads -- with its
stacked ``"layers"`` leaves per group (leading axis = the group's
repeats), and returns the port's `LM` with one `Params` per layer, in
stack order, and zamba2's model-level ``"shared"`` block as it is (the
per-invocation LoRA leaves come with their layers; an MoE layer's
``"moe"`` subtree, its f32 router included, like any other).  Both then
compute the same function.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import blocks
from repro_torch.models.lm import LM


def _tree(node: Any, device: torch.device, index=None):
    """Nested mapping of arrays -> nested dict of tensors on `device`,
    taking `[index]` of every leaf when an index is given."""
    if isinstance(node, Mapping):
        return {k: _tree(v, device, index) for k, v in node.items()}
    arr = np.asarray(node)
    if index is not None:
        arr = arr[index]
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def from_jax(params: Mapping, cfg: ArchConfig, device: DeviceLike = None) -> LM:
    """The reference's `init_lm(key, cfg)` pytree -> the port's `LM` on
    `device` (cuda unless the caller names another)."""
    dev = resolve_device(device)
    plan = blocks.build_stack_plan(cfg)
    layers = []
    for gspec, group in zip(plan, params["stack"], strict=True):
        for r in range(gspec.n_repeat):
            for i in range(len(gspec.layers)):
                layers.append(_tree(group["layers"][i], dev, index=r))
    tree = {k: _tree(params[k], dev)
            for k in ("embed", "final_norm", "lm_head", "shared") if k in params}
    tree["layers"] = layers
    return LM(cfg, tree)
