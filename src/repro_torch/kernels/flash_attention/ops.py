"""Flash attention's entry points: the forward (`flash_attention`, in the
reference kernel's domain; `flash_forward`, any Sk), the forward with its
log-sum-exp (`flash_attention_fwd`) and the backward
(`flash_attention_bwd`) that training reads.

The device decides the path: a CUDA tensor launches the CUDA kernel
(`kernel.flash_attention_call`, `backward.flash_attention_bwd_call`) or
raises, a CPU tensor runs the plain version (`ref`), and a meta tensor
runs neither: empty meta outputs in the kernel's layouts, the call
reported with its cost (`kernels.meta`, the dry run's op counter).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import meta as _meta
from repro_torch.kernels.flash_attention import backward as _backward
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_attention_bwd_ref,
    lse_ref,
)

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
    return flash_forward(q, k, v, causal=causal, window=window)


def _shape_args(q, k, v, causal: bool, window: int) -> dict:
    b, hq, sq, hd = q.shape
    return dict(b=b, hq=hq, hkv=k.shape[1], sq=sq, sk=k.shape[2], hd=hd, vd=v.shape[3],
                causal=bool(causal), window=int(window), itemsize=q.element_size())


def _meta_forward(q, k, v, causal: bool, window: int, lse: bool):
    """The forward on the meta device: o in q's layout (and the f32 lse),
    reported as one call of the kernel."""
    _meta.record("flash_attention", _kernel.cost(**_shape_args(q, k, v, causal, window),
                                                 lse=lse))
    o = _kernel.empty_in_layout(q, v.shape[3])
    if not lse:
        return o
    return o, torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """The forward's output at any Sq and Sk: what the model's attention
    calls, as the reference's model-level flash (which pads Sk with keys
    its masks drop) takes any Sk."""
    window = int(window or 0)
    if q.device.type == "cuda":
        return _kernel.flash_attention_call(q, k, v, causal=causal, window=window)
    if _meta.is_meta(q):
        return _meta_forward(q, k, v, causal, window, lse=False)
    return attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward's output and the f32 (B, Hq, Sq) log-sum-exp
    of each row's scaled scores (0 for a row that sees no key)."""
    if q.device.type == "cuda":
        return _kernel.flash_attention_call(
            q, k, v, causal=causal, window=window, return_lse=True)
    if _meta.is_meta(q):
        return _meta_forward(q, k, v, causal, window, lse=True)
    return (attention_ref(q, k, v, causal=causal, window=window),
            lse_ref(q, k, causal=causal, window=window))


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's q, k, v, o, lse and the gradient
    dO of o."""
    if q.device.type == "cuda":
        return _backward.flash_attention_bwd_call(
            q, k, v, o, lse, do, causal=causal, window=window)
    if _meta.is_meta(q):
        _meta.record("flash_attention_bwd",
                     _backward.cost(**_shape_args(q, k, v, causal, window)))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
