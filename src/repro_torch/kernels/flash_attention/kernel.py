"""The CUDA flash-attention kernel's wrapper: build, bind, validate, launch.

`csrc/flash_attention.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `flash_attention_call` takes CUDA tensors only and
raises on anything the kernel does not take; the plain version of the
same function is `ref.attention_ref` (and `ref.lse_ref` for the
log-sum-exp that training's backward reads).  `LAUNCHES` counts the
kernel's launches.

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

# the kernel's instantiations, (q / k head dim, v head dim): every head dim
# a registered config uses (stablelm-3b's 80, zamba2-7b's 112, deepseek-v3's
# MLA at (192, 128) and its MTP block's 56) and the powers of two 16..256
HEAD_DIMS = ((16, 16), (32, 32), (56, 56), (64, 64), (80, 80), (112, 112), (128, 128),
             (192, 128), (256, 256))

SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu"
# `flash_attention_launch`'s C signature, in order (the stream is appended)
ARGTYPES = (
    [ctypes.c_void_p] * 5  # q, k, v, o, lse (null: not written)
    + [ctypes.c_int] * 7  # batch, hq, hkv, sq, sk, hd, vd
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


def empty_in_layout(t: torch.Tensor, last: int) -> torch.Tensor:
    """An uninitialised f32 tensor of `t`'s shape with the last dim `last`,
    its first three dims in `t`'s memory order (so a (B, H, S, hd) view of
    a (B, S, H, hd) tensor gets a (B, H, S, last) view of a (B, S, H,
    last) one)."""
    order = sorted(range(3), key=lambda i: -t.stride(i))  # outermost first
    out = torch.empty([t.shape[i] for i in order] + [last], dtype=t.dtype, device=t.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention_call(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int,
    return_lse: bool = False,
):
    """Launch the kernel on the current stream.

    q: (B, Hq, Sq, hd), k: (B, Hkv, Sk, hd), v: (B, Hkv, Sk, vd) f32 on
    the card, any (batch, head, sequence) strides with the head dim
    contiguous; Hq % Hkv == 0, (hd, vd) in `HEAD_DIMS`; the scale is q's
    hd^-0.5.  Sq and Sk need not be multiples of the kernel's tiles: the
    ragged edges are masked in the kernel.
    returns: (B, Hq, Sq, vd) in q's memory layout; with `return_lse`
    also the f32 log-sum-exp of each row's scaled scores, (B, Hq, Sq)
    contiguous (0 for a row that sees no key).  Writing it changes no
    bit of the output.
    """
    global LAUNCHES
    _build.refuse_grad("flash_attention", "training goes through "
                       "repro_torch.models.flash_attention, which has one", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    b, hq, sq, hd = q.shape
    hkv, sk, vd = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, hkv, sk, hd) or tuple(v.shape) != (b, hkv, sk, vd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
    if (hd, vd) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {hd}, v {vd}) are not one of the kernel's "
                         f"instantiations {HEAD_DIMS} (the registered configs' head dims)")
    out = empty_in_layout(q, vd)  # q's layout
    _check("out", out, q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    LIB.launch(
        "flash_attention_launch", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, hq, hkv, sq, sk, hd, vd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), hd ** -0.5,
    )
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return (out, lse) if return_lse else out
