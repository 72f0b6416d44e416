"""Load the reference's LM parameters into the port.

`from_jax(params, cfg)` takes the pytree that the reference's `init_lm`
returns -- as numpy arrays or anything `numpy.asarray` reads -- with its
stacked ``"layers"`` leaves per group (leading axis = the group's
repeats), and returns the port's `LM` with one `Params` per layer, in
stack order, and the model-level subtrees as they are: zamba2's
``"shared"`` block (the per-invocation LoRA leaves come with their
layers), DeepSeek-V3's ``"mtp"`` head, and an encoder-decoder's
``"encoder"`` (its stacked layers, unstacked the same way, and its
``"final_norm"``).  An MoE layer's ``"moe"`` subtree, its f32 router
included, an MLA layer's ``"attn"`` leaves and a decoder layer's
``"ln_cross"`` / ``"cross"`` come with their layers like any other.  Both
then compute the same function.

Each leaf keeps its dtype, bit for bit: a bf16 leaf (numpy's
`ml_dtypes.bfloat16`, which `torch.from_numpy` refuses) is carried as its
16-bit patterns and viewed as `torch.bfloat16`, and an f32 leaf of a bf16
tree (an MoE router, mamba's `dt_bias`, `A_log` and `D`) stays f32.
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
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: its bits, viewed as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _layers(plan, stack, device: torch.device) -> list:
    """A plan's stacked groups -> one tree per layer, in stack order."""
    layers = []
    for gspec, group in zip(plan, stack, strict=True):
        for r in range(gspec.n_repeat):
            for i in range(len(gspec.layers)):
                layers.append(_tree(group["layers"][i], device, index=r))
    return layers


def from_jax(params: Mapping, cfg: ArchConfig, device: DeviceLike = None) -> LM:
    """The reference's `init_lm(key, cfg)` pytree -> the port's `LM` on
    `device` (cuda unless the caller names another)."""
    dev = resolve_device(device)
    tree = {k: _tree(params[k], dev)
            for k in ("embed", "final_norm", "lm_head", "shared", "mtp") if k in params}
    tree["layers"] = _layers(blocks.build_stack_plan(cfg), params["stack"], dev)
    if "encoder" in params:
        enc = params["encoder"]
        tree["encoder"] = {
            "layers": _layers(blocks.build_stack_plan(cfg, "encoder"), enc["stack"], dev),
            "final_norm": _tree(enc["final_norm"], dev),
        }
    return LM(cfg, tree)
