"""The dry run's meshes.

`make_production_mesh` is the reference's production mesh, single-pod
16 x 16 or 2-pod 2 x 16 x 16, as a logical `Mesh`: it is used only for
per-card accounting and never places a tensor.  `make_host_mesh` spans
the visible CUDA cards (one on a one-card machine); tests pass a device
list.  Functions, not module constants: importing this module touches
no device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return Mesh(shape, logical=True)


def make_host_mesh(model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over `devices` (the visible CUDA cards by
    default); raises when `model` does not divide their count."""
    if devices is None:
        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError("no CUDA device available: pass devices= to build a host mesh")
        devices = [f"cuda:{i}" for i in range(n)]
    n = len(devices)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the {n} devices")
    return Mesh({"data": n // model, "model": model}, devices)
