"""Forward flash attention's entry point.

The device decides the path: a CUDA tensor launches the CUDA kernel
(`kernel.flash_attention_call`) or raises, a CPU tensor runs the plain
version (`ref.attention_ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

# the reference wrapper's kv block: it pads Sk up to a multiple of it,
# which only a causal mask keeps harmless
REFERENCE_KV_BLK = 128


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Sk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention with the reference kernel's domain and semantics: any Sq;
    any Sk when causal, else Sk a multiple of min(128, Sk) (the reference
    raises there, and so does this)."""
    sk = k.shape[2]
    if not causal and sk % min(REFERENCE_KV_BLK, sk):
        raise ValueError(
            f"non-causal attention needs Sk % {min(REFERENCE_KV_BLK, sk)} == 0, "
            f"got Sk={sk}"
        )
    window = int(window or 0)
    if q.device.type == "cuda":
        return _kernel.flash_attention_call(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
