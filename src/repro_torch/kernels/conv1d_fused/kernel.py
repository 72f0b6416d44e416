"""The CUDA causal-conv1d kernel's wrapper: build, bind, validate, launch.

`csrc/conv1d_fused.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `conv1d_fused_call` takes CUDA tensors only and
raises on anything the kernel does not take; the plain version of the
same function is `ref.conv1d_ref`.  `LAUNCHES` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

MAX_TAPS = 8  # the kernel is instantiated for K = 1..8

SOURCE = pathlib.Path(__file__).parent / "csrc" / "conv1d_fused.cu"
# `conv1d_fused_launch`'s C signature, in order (the stream is appended)
ARGTYPES = (
    [ctypes.c_void_p] * 4  # x, w, b, out
    + [ctypes.c_int] * 3  # batch, seq, d
    + [ctypes.c_longlong]  # x_row_stride
    + [ctypes.c_int] * 3  # k, strip, silu
    + [ctypes.c_void_p]  # stream
)
LIB = _build.CudaLibrary(SOURCE, "conv1d_fused", {"conv1d_fused_launch": ARGTYPES})


def conv1d_fused_call(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    strip: int,
    activation: str,
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    x: (B, L, D) f32 on the card, channels contiguous; its rows may be
       further apart than D (a column slice of a wider activation is read
       in place).
    w: (K, D), b: (D,) f32 contiguous, K <= 8.  strip: rows per block.
    returns: (B, L, D) contiguous, act(causal conv + b).
    """
    global LAUNCHES
    if activation not in ("silu", "none"):
        raise ValueError(f"activation must be 'silu' or 'none', got {activation!r}")
    if x.ndim != 3 or w.ndim != 2 or b.ndim != 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} b {tuple(b.shape)}")
    bsz, length, d = x.shape
    k = w.shape[0]
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(w.shape) != (k, d) or tuple(b.shape) != (d,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not match D={d}")
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"K={k} taps; the kernel takes 1..{MAX_TAPS}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("w and b must be contiguous")
    row = x.stride(1)
    if x.stride(2) != 1 or row < d or (bsz > 1 and x.stride(0) != length * row):
        raise ValueError(f"x strides {x.stride()} are not (L*R, R, 1) with R >= D")
    if strip < 1:
        raise ValueError(f"strip {strip} < 1")
    out = torch.empty((bsz, length, d), dtype=torch.float32, device=x.device)
    LIB.launch(
        "conv1d_fused_launch", x.device,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz, length, d, row, k, strip, int(activation == "silu"),
    )
    LAUNCHES += 1
    return out
