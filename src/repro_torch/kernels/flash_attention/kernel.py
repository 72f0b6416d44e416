"""The CUDA flash-attention kernel's wrapper: build, bind, validate, launch.

`csrc/flash_attention.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `flash_attention_call` takes CUDA tensors only and
raises on anything the kernel does not take; the plain version of the
same function is `ref.attention_ref` (and `ref.lse_ref` for the
log-sum-exp that training's backward reads).  `LAUNCHES` counts the
kernel's launches.  fp32 inputs launch the fp32 instantiation
(`flash_attention_launch`), bf16 inputs the bf16 one
(`flash_attention_bf16_launch`: bf16 P for P.V, bf16 output); nothing
else is taken.

The kernel addresses q, k, v and the output by (batch, head, sequence)
strides with the head dim contiguous, so a (B, H, S, hd) view of the
model's (B, S, H, hd) activations is passed as it is -- no transpose is
copied -- and the output is allocated in q's memory layout.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
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
    SOURCE, "flash_attention",
    {"flash_attention_launch": ARGTYPES, "flash_attention_bf16_launch": ARGTYPES},
)
# the entry point of each element type the kernel takes
ENTRY = {torch.float32: "flash_attention_launch", torch.bfloat16: "flash_attention_bf16_launch"}


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be (B, H, S, hd) with hd contiguous")
    per16 = 16 // t.element_size()  # elements in 16 bytes
    if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned (strides {t.stride()})")


def empty_in_layout(t: torch.Tensor, last: int) -> torch.Tensor:
    """An uninitialised tensor of `t`'s dtype and shape with the last dim `last`,
    its first three dims in `t`'s memory order (so a (B, H, S, hd) view of
    a (B, S, H, hd) tensor gets a (B, H, S, last) view of a (B, S, H,
    last) one)."""
    order = sorted(range(3), key=lambda i: -t.stride(i))  # outermost first
    out = torch.empty([t.shape[i] for i in order] + [last], dtype=t.dtype, device=t.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


@functools.lru_cache(maxsize=256)
def band_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(q row, key) pairs that the masks let through (`ref.band_mask`),
    counted row by row: row i sees keys [i - window + 1, i] (no lower end
    without a window, no upper end but Sk without causal), clipped to Sk.
    In numpy, not torch: the dry run calls it under its op counter."""
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(sk, i + 1) if causal else np.full_like(i, sk)
    return int(np.maximum(0, hi - lo).sum())


def cost(b: int, hq: int, hkv: int, sq: int, sk: int, hd: int, vd: int, *, causal: bool,
         window: int, itemsize: int = 4, lse: bool = False) -> tuple:
    """(FLOPs, bytes) of the function the forward computes: the two
    products (QK^T over hd, P.V over vd) of every (q row, key) pair the
    masks let through, per (batch, q head); q, k and v read once and o
    written once at `itemsize` bytes a value (and, with `lse`, the f32
    log-sum-exp written beside it)."""
    flops = 2 * (hd + vd) * band_pairs(sq, sk, causal, window) * b * hq
    n_bytes = itemsize * (b * hq * sq * hd + b * hkv * sk * (hd + vd) + b * hq * sq * vd)
    return flops, n_bytes + (4 * b * hq * sq if lse else 0)


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

    q: (B, Hq, Sq, hd), k: (B, Hkv, Sk, hd), v: (B, Hkv, Sk, vd) on the
    card, all f32 or all bf16, any (batch, head, sequence) strides with
    the head dim contiguous; Hq % Hkv == 0, (hd, vd) in `HEAD_DIMS`; the scale is q's
    hd^-0.5.  Sq and Sk need not be multiples of the kernel's tiles: the
    ragged edges are masked in the kernel.
    returns: (B, Hq, Sq, vd) in q's dtype and memory layout; with `return_lse`
    also the f32 log-sum-exp of each row's scaled scores, (B, Hq, Sq)
    contiguous (0 for a row that sees no key).  Writing it changes no
    bit of the output.
    """
    global LAUNCHES
    _build.refuse_grad("flash_attention", "training goes through "
                       "repro_torch.models.flash_attention, which has one", q, k, v)
    if q.dtype not in ENTRY:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device, q.dtype)
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
    _check("out", out, q.device, q.dtype)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    LIB.launch(
        ENTRY[q.dtype], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, hq, hkv, sq, sk, hd, vd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), hd ** -0.5,
    )
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return (out, lse) if return_lse else out
