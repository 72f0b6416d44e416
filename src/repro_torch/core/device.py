"""Where the port runs: the one rule every entry point applies.

Entry points (`Engine`, `conv2d`, `conv2d_fused_tile`) run on the CUDA
card unless the caller names another device.  Without a card and
without a named device they raise: nothing quietly falls back to the
CPU.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_STREAMS = threading.local()  # a thread's own CUDA streams, by card index


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


def canonical(device: DeviceLike) -> torch.device:
    """`device` with its card named: a bare ``cuda`` is the current card
    (``cuda:0`` on a fresh process), so two spellings of one card compare
    equal.  Reading the current card touches no card."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def thread_stream(device: DeviceLike) -> "torch.cuda.Stream":
    """This thread's own CUDA stream on `device`'s card, made on first
    use: one per (thread, card), since a stream belongs to one card and a
    thread may serve several (a pool worker, a sharded wave)."""
    card = canonical(device)
    streams = getattr(_STREAMS, "by_card", None)
    if streams is None:
        streams = _STREAMS.by_card = {}
    s = streams.get(card.index)
    if s is None:
        s = streams[card.index] = torch.cuda.Stream(device=card)
    return s


def publish(t):
    """Make `t`, just computed on the current stream, safe to read from
    any stream: on the card, wait for the current stream to finish.  Every
    memo that replica threads share (each on its own stream) calls this on
    a miss before it stores the entry; on the CPU it does nothing."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def transient(t: torch.Tensor) -> torch.Tensor:
    """Mark `t` as one read's own buffer (a transform gathered from the
    mesh's cards for one wave): made on the current stream and read only
    there, so a memo keyed by its identity derives what it needs for that
    call alone, neither kept nor published."""
    t.transient_read = True
    return t


def is_transient(t) -> bool:
    return getattr(t, "transient_read", False)


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32" (the plan files' dtype spelling)."""
    return str(dtype).removeprefix("torch.")


def host_array(t):
    """`t` as a host numpy array; a bf16 tensor (numpy has no bf16) as
    float32, which holds its values exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
