"""AdamW from scratch, with low-precision moment options: the port of
`src/repro/optim/adamw.py`, as plain functions on tensors.

Moment dtypes:
  float32         textbook
  bfloat16        halves the optimizer's memory
  int8            block-wise-quantised moments (8-bit-Adam style): int8
                  payload + one f32 scale per block of 256, the second
                  moment quantised in the sqrt domain

The update math always runs in f32; only storage is quantised.  It is the
reference's, operation for operation: clipping by the global norm, bias
correction, the update cap 2/sqrt(1 - b2), and decoupled weight decay on
tensors with ndim >= 2 only.  `torch.optim.AdamW` is not used: it has no
cap, no clipping and decays every tensor.

Params, grads and moments are mappings from a parameter's name to its
tensor (an int8 moment is ``{"q", "scale"}``).  Where the reference
returns new trees, `adamw_update` writes the parameters, the moments and
the step count in place (under `torch.no_grad`): it saves a copy of
every tensor each step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Tuple, Union

import torch

_QBLOCK = 256

Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# block-wise int8 moment codec
# ---------------------------------------------------------------------------


def _q8_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _QBLOCK))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return {"q": q, "scale": scale.float()[:, 0]}


def _q8_decode(enc: Mapping[str, torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    flat = (enc["q"].float() * enc["scale"][:, None]).reshape(-1)
    return flat[: p.numel()].reshape(p.shape)


def _moment_init(p: torch.Tensor, dtype: str) -> Moment:
    if dtype == "int8":
        return _q8_encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    return torch.zeros(p.shape, dtype=getattr(torch, dtype), device=p.device)


def _moment_read(m: Moment, p: torch.Tensor, dtype: str, sqrt_domain: bool = False):
    if dtype == "int8":
        val = _q8_decode(m, p)
        # the second moment is quantised in sqrt space (halved dynamic
        # range => far better small-value resolution for 1/sqrt(v))
        return val * val if sqrt_domain else val
    return m.float()


def _moment_write(m: Moment, val: torch.Tensor, dtype: str, sqrt_domain: bool = False):
    """Store `val` into the moment `m` in place."""
    if dtype == "int8":
        enc = _q8_encode(torch.sqrt(val) if sqrt_domain else val)
        m["q"].copy_(enc["q"])
        m["scale"].copy_(enc["scale"])
    else:
        m.copy_(val)  # rounds to the moment's dtype


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict:
    """Zero moments beside each parameter and a step count of 0."""
    device = next(iter(params.values())).device
    return {
        "m": {n: _moment_init(p, cfg.moment_dtype) for n, p in params.items()},
        "v": {n: _moment_init(p, cfg.moment_dtype) for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every tensor's sum of squares, in f32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    opt_state: Dict,
    cfg: AdamWConfig,
    lr_scale: Union[torch.Tensor, float] = 1.0,
) -> Tuple[Mapping[str, torch.Tensor], Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, opt_state, metrics
    ``grad_norm`` and ``clip``), the same objects it was given."""
    count = opt_state["count"]
    count.add_(1)
    gnorm = global_norm(grads[n] for n in params)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = count.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = torch.as_tensor(lr_scale, dtype=torch.float32, device=count.device) * cfg.lr

    # exact Adam bounds |update| by ~1/sqrt(1-b2); quantised moments can
    # break that when a v-block underflows to 0, so clamp (a no-op for
    # exact moments, the safety rail for int8 ones)
    update_cap = 2.0 / math.sqrt(1.0 - cfg.b2)

    for name, p in params.items():
        g32 = grads[name].float() * clip
        m_enc, v_enc = opt_state["m"][name], opt_state["v"][name]
        m = _moment_read(m_enc, p, cfg.moment_dtype)
        v = _moment_read(v_enc, p, cfg.moment_dtype, sqrt_domain=True)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        update = torch.clamp(update, -update_cap, update_cap)
        p32 = p.float()
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            p32 = p32 * (1.0 - lr * cfg.weight_decay)
        p32 = p32 - lr * update
        p.copy_(p32)
        _moment_write(m_enc, m, cfg.moment_dtype)
        _moment_write(v_enc, v, cfg.moment_dtype, sqrt_domain=True)
    return params, opt_state, {"grad_norm": gnorm, "clip": clip}


def warmup_cosine(step, *, peak: float = 1.0, warmup: int = 100, total: int = 10000):
    """lr multiplier schedule (multiplies AdamWConfig.lr), an f32 0-d
    tensor on `step`'s device (the CPU for a Python number)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return peak * warm * (0.1 + 0.9 * cos)
