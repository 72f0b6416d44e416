"""The CUDA flash-attention kernel's wrapper: build, bind, validate, launch.

`csrc/flash_attention.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `flash_attention_call` takes CUDA tensors only and
raises on anything the kernel does not take; the plain version of the
same function is `ref.attention_ref`.  `LAUNCHES` counts the kernel's
launches.

The kernel addresses q, k, v and the output by (batch, head, sequence)
strides with the head dim contiguous, so a (B, H, S, hd) view of the
model's (B, S, H, hd) activations is passed as it is -- no transpose is
copied -- and the output is allocated in q's memory layout.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations

SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu"
# `flash_attention_launch`'s C signature, in order (the stream is appended)
ARGTYPES = (
    [ctypes.c_void_p] * 4  # q, k, v, o
    + [ctypes.c_int] * 6  # batch, hq, hkv, sq, sk, hd
    + [ctypes.c_longlong] * 12  # (b, h, s) strides of q, k, v, o
    + [ctypes.c_int] * 2  # causal, window
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
LIB = _build.CudaLibrary(
    SOURCE, "flash_attention", {"flash_attention_launch": ARGTYPES}
)


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be (B, H, S, hd) with hd contiguous")
    if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned (strides {t.stride()})")


def flash_attention_call(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int,
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    q: (B, Hq, Sq, hd), k/v: (B, Hkv, Sk, hd) f32 on the card, any
    (batch, head, sequence) strides with hd contiguous; Hq % Hkv == 0,
    hd in `HEAD_DIMS`.  Sq and Sk need not be multiples of the kernel's
    tiles: the ragged edges are masked in the kernel.
    returns: (B, Hq, Sq, hd) in q's memory layout.
    """
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, sk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    out = torch.empty_like(q)  # q's layout (dense views keep their strides)
    _check("out", out, q.device)
    LIB.launch(
        "flash_attention_launch", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, sk, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), hd ** -0.5,
    )
    LAUNCHES += 1
    return out
