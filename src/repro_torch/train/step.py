"""Train-step factory: loss -> grads -> clip -> AdamW, remat + microbatching
-- the port of `src/repro/train/step.py`.

The train state is ``{"params": LM, "opt": AdamW state, "step": int32
0-d tensor}``, all on the model's device.  `init_train_state` turns
gradients on for the state's parameters (serving's models keep them
off).  The step takes host batches (numpy or tensors) and moves them to
the device.

Gradient accumulation over microbatches is a Python loop that sums f32
gradients and divides by their count, as the reference's scan does.
The loss and its gradients run under `f32_accumulation`: for a bf16
model cuBLAS sums bf16 products in f32 in the backward as in the
forward, as the reference's dots do; AdamW updates in f32 and rounds
each parameter to its dtype.
`distributed/collectives.py` (the compressed multi-host all-reduce) is
not ported: one card reduces nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import f32_accumulation
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, warmup_cosine

State = Dict


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # grad accumulation steps per global step
    remat: bool = True
    warmup_steps: int = 100
    total_steps: int = 10000


def train_state(model: lm_mod.LM, tcfg: TrainConfig) -> State:
    """The train state around `model` (e.g. weights loaded with
    `from_jax`): gradients on, zero moments, step 0."""
    model.requires_grad_(True)
    return {
        "params": model,
        "opt": adamw_init(dict(model.named_parameters()), tcfg.optimizer),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def init_train_state(
    cfg: ArchConfig, tcfg: TrainConfig, seed: int = 0, device: DeviceLike = None
) -> State:
    """Random weights from `seed` on `device` (cuda unless named)."""
    return train_state(lm_mod.init_lm(cfg, seed=seed, device=device), tcfg)


def _to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device, dtype=torch.long if k in ("tokens", "targets") else None)
    return out


def make_train_step(
    cfg: ArchConfig, tcfg: TrainConfig
) -> Callable[[State, Dict], Tuple[State, Dict[str, torch.Tensor]]]:
    def train_step(state: State, batch: Dict) -> Tuple[State, Dict[str, torch.Tensor]]:
        model = state["params"]
        names, params = zip(*model.named_parameters())
        batch = _to_device(batch, model.device)
        metrics: Dict[str, torch.Tensor]
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
            lsum: Optional[torch.Tensor] = None
            for i in range(n):
                mb = {}
                for k, x in batch.items():
                    if x.shape[0] % n:
                        raise ValueError(f"batch {x.shape[0]} does not split into {n} microbatches")
                    mb[k] = x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
                with f32_accumulation():
                    loss, _ = lm_mod.lm_loss(model, mb, remat=tcfg.remat)
                    mgrads = torch.autograd.grad(loss, params)
                for acc, g in zip(gsum, mgrads):
                    acc.add_(g.float())
                lsum = loss.detach() if lsum is None else lsum + loss.detach()
            grads = [g / n for g in gsum]
            loss = lsum / n
            metrics = {"loss": loss}
        else:
            with f32_accumulation():
                loss, metrics = lm_mod.lm_loss(model, batch, remat=tcfg.remat)
                grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}

        lr_scale = warmup_cosine(
            state["step"], warmup=tcfg.warmup_steps, total=tcfg.total_steps
        )
        _, opt, opt_metrics = adamw_update(
            dict(zip(names, params)), dict(zip(names, grads)), state["opt"],
            tcfg.optimizer, lr_scale,
        )
        new_state = {"params": model, "opt": opt, "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
