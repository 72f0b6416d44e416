"""Where the port runs: the one rule every entry point applies.

Entry points (`Engine`, `conv2d`, `conv2d_fused_tile`) run on the CUDA
card unless the caller names another device.  Without a card and
without a named device they raise: nothing quietly falls back to the
CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; ``cuda`` when None (raises without a
    card -- pass ``device="cpu"`` to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32" (the plan files' dtype spelling)."""
    return str(dtype).removeprefix("torch.")

