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


def publish(t):
    """Make `t`, just computed on the current stream, safe to read from
    any stream: on the card, wait for the current stream to finish.  Every
    memo that replica threads share (each on its own stream) calls this on
    a miss before it stores the entry; on the CPU it does nothing."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32" (the plan files' dtype spelling)."""
    return str(dtype).removeprefix("torch.")


def host_array(t):
    """`t` as a host numpy array; a bf16 tensor (numpy has no bf16) as
    float32, which holds its values exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
