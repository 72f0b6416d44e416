"""The CUDA flash-attention backward kernel's wrapper: build, bind,
validate, launch.

`csrc/flash_attention_bwd.cu` is compiled with nvcc for sm_90a on first
use (`kernels._build`).  `flash_attention_bwd_call` takes CUDA tensors
only and raises on anything the kernel does not take; the plain version
of the same function is `ref.flash_attention_bwd_ref`.  `LAUNCHES`
counts the wrapper's calls that launched the kernel (each launches the
source's three kernels: delta, dK/dV, dQ).

Like the forward, the kernel addresses every tensor by (batch, head,
sequence) strides with the head dim contiguous: the model's transposed
views are read in place, dO is copied once only when its head dim is
not contiguous or it is not 16-byte aligned, and the gradients come back
in q's, k's and v's memory layouts.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, _check

LAUNCHES = 0  # wrapper calls that launched the kernel since import (or a reset)

SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention_bwd.cu"
# `flash_attention_bwd_launch`'s C signature, in order (the stream is appended)
ARGTYPES = (
    [ctypes.c_void_p] * 10  # q, k, v, o, lse, dO, dq, dk, dv, delta scratch
    + [ctypes.c_int] * 6  # batch, hq, hkv, sq, sk, hd
    + [ctypes.c_longlong] * 24  # (b, h, s) strides of q, k, v, o, dO, dq, dk, dv
    + [ctypes.c_int] * 2  # causal, window
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
LIB = _build.CudaLibrary(
    SOURCE, "flash_attention_bwd", {"flash_attention_bwd_launch": ARGTYPES}
)


def _aligned(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:3])


def flash_attention_bwd_call(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream.

    q, o, do: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd), f32 on the card,
    any (batch, head, sequence) strides with hd contiguous; lse: the
    forward kernel's (B, Hq, Sq) log-sum-exp.  Hq % Hkv == 0, hd in
    `HEAD_DIMS`, any Sq and Sk (masks by index, as the forward).
    returns: (dq, dk, dv) in q's, k's and v's memory layouts.
    """
    global LAUNCHES
    dev = q.device
    if do.device == dev and do.dtype == torch.float32 and do.ndim == 4 and not _aligned(do):
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, t, dev)
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, sk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of the kernel's instantiations {HEAD_DIMS}")
    if (lse.device != dev or lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be the forward's contiguous f32 (B, Hq, Sq) on {dev}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check(name, t, dev)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    LIB.launch(
        "flash_attention_bwd_launch", dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        b, hq, hkv, sq, sk, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        int(causal), int(window), hd ** -0.5,
    )
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return dq, dk, dv
