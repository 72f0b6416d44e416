"""Carry weights over from the reference package.

The reference's `init_weights` and checkpoints hold `{layer: array}`
with HWIO conv kernels and (C,) bias vectors; `from_jax` turns such a
dict (any array type numpy can read) into torch tensors on `device`,
unchanged bit for bit, so both packages serve the same parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


def from_jax(ws: Mapping[int, object], device: DeviceLike = None) -> Dict[int, torch.Tensor]:
    """{layer: HWIO kernel or bias vector} -> {layer: torch.Tensor} on
    `device` (cuda unless named), same dtype and values."""
    dev = resolve_device(device)
    return {
        int(i): torch.from_numpy(np.array(w, copy=True)).to(dev)
        for i, w in ws.items()
    }
