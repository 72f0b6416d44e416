"""Shared model components: norms, rotary embeddings, the loss,
initialisers."""

from __future__ import annotations

import contextlib
import math
from typing import Any, Mapping, Optional, Tuple

import torch


@contextlib.contextmanager
def f32_accumulation():
    """Inside, cuBLAS sums bf16 products in f32 (no reduced-precision
    reductions), as the reference's bf16 dots do, whatever the caller's
    global setting; that setting is restored after.  The serving entry
    points (`lm_logits`, `lm_prefill`, `lm_decode_step`) run under it."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, scaled by (1 + scale) (the scale is stored as
    zeros at init, gemma-style)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rotary_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (...,) int -> (..., dim//2) angles."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    freqs = theta ** (-exps / dim)
    return positions.float()[..., None] * freqs


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> rotated x (half-split convention)."""
    hd = x.shape[-1]
    ang = rotary_angles(positions, hd, theta)  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean token NLL with f32 logits; targets (B, S) int; mask optional
    (the masked mean over max(sum(mask), 1))."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def pad_vocab(vocab_size: int, multiple: int = 2048) -> int:
    """Embedding tables are padded to a multiple of 2048 rows, as in the
    reference (whose vocab axis shards evenly); padded logits are cut."""
    return -(-vocab_size // multiple) * multiple


def truncated_normal(
    gen: torch.Generator, shape: Tuple[int, ...], std: float, dtype, device
) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times `std`, drawn from `gen` by
    inverting the CDF of a uniform draw (the reference's initialiser's
    distribution; the numbers differ from JAX's).  Each step works in
    place, so a draw needs no memory beyond its own f32 tensor (one
    layer of deepseek-v3's 256 experts is three 15 GB draws).  On the
    meta device it draws nothing: `gen` is None there, and the tensor
    has the shape and dtype alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    z = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    z.mul_(1.0 - 2.0 * lo).add_(lo)  # uniform on [cdf(-2), cdf(2)]
    z.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
    return z.clamp_(-2.0, 2.0).mul_(std).to(dtype)


def dense_init(
    gen: torch.Generator, shape, dtype, device, fan_in: Optional[int] = None
) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal(gen, tuple(shape), 1.0 / math.sqrt(fan_in), dtype, device)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    # std = 1/sqrt(d_model): keeps tied-head logits O(1) at init
    return truncated_normal(gen, tuple(shape), shape[-1] ** -0.5, dtype, device)


class Params(torch.nn.Module):
    """A nested mapping of frozen tensors as a Module: the port's form of
    the reference's parameter pytrees.  ``p["wq"]`` and ``"bq" in p`` read
    like the reference's dicts, while `.to()`, `state_dict()` and
    `parameters()` work as on any Module.  Sub-mappings become nested
    `Params`; a module in the tree is registered as it is.  The tensors are Parameters registered with
    ``requires_grad=False``: serving (under `inference_mode`) never needs
    a gradient, and training turns gradients on for its train state's
    parameters only (`train.step.train_state`)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, torch.nn.Module):  # shared, not copied
                self.add_module(name, val)
            elif isinstance(val, Mapping):
                self.add_module(name, Params(val))
            else:
                self.register_parameter(
                    name, torch.nn.Parameter(torch.as_tensor(val), requires_grad=False)
                )

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules
