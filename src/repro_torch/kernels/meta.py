"""The hand-written kernels on the meta device: shapes and costs, no launch.

A kernel wrapper given meta tensors runs neither its kernel nor its plain
version.  It returns empty meta outputs of the kernel's shapes and memory
layouts, and reports the call -- the kernel's name (the key its
`LAUNCHES` counter has in `chip_smoke.py`) and its cost, (FLOPs, bytes)
from the kernel package's `cost` -- to every listener.  The dry run's op
counter (`launch.hlo_analysis.OpCounter`) listens: it counts each call
as one op with the kernel's own FLOPs and bytes, so the plain version's
intermediates (the S x S scores of attention) never count.  `LAUNCHES`
does not move.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List

import torch

_LISTENERS: List[Callable[[str, int, int], None]] = []
_LOCK = threading.Lock()


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def record(name: str, cost) -> None:
    """Report one call of kernel `name` with its (FLOPs, bytes)."""
    flops, n_bytes = cost
    with _LOCK:
        listeners = list(_LISTENERS)
    for fn in listeners:
        fn(name, int(flops), int(n_bytes))


@contextlib.contextmanager
def listen(fn: Callable[[str, int, int], None]):
    """Inside, `fn(name, flops, bytes)` hears every meta kernel call."""
    with _LOCK:
        _LISTENERS.append(fn)
    try:
        yield fn
    finally:
        with _LOCK:
            _LISTENERS.remove(fn)
