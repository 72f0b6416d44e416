"""Dense SwiGLU MLP."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_mlp import decode_mlp
from repro_torch.models.common import dense_init


def init_mlp(gen, d_model: int, d_ff: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "w1": dense_init(gen, (d_model, d_ff), dtype, device),
        "w3": dense_init(gen, (d_model, d_ff), dtype, device),
        "w2": dense_init(gen, (d_ff, d_model), dtype, device, fan_in=d_ff),
    }


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLP (prefill): plain matmuls, as the reference left
    them to XLA."""
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def mlp_decode(p, x: torch.Tensor) -> torch.Tensor:
    """The decode step's MLP, x (B, 1, D): the fused decode-MLP kernel on
    the card (its plain version on the CPU)."""
    b, _, d = x.shape
    return decode_mlp(x.reshape(b, d), p["w1"], p["w3"], p["w2"]).reshape(b, 1, d)
