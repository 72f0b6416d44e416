"""The CUDA decode-MLP kernel's wrapper: build, bind, validate, launch.

`csrc/decode_mlp.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `decode_mlp_call` takes CUDA tensors only and raises
on anything the kernel does not take; the plain version of the same
function is `ref.decode_mlp_ref`.  `LAUNCHES` counts the kernel's
launches (one per call: the d_ff-block pass and its fixed-order
reduction of partials are launched together).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

MAX_SMEM_BYTES = 232_448  # per-block opt-in shared memory of sm_90

SOURCE = pathlib.Path(__file__).parent / "csrc" / "decode_mlp.cu"
# `decode_mlp_launch`'s C signature, in order (the stream is appended)
ARGTYPES = (
    [ctypes.c_void_p] * 6  # x, w1, w3, w2, part, out
    + [ctypes.c_int] * 3  # batch, d, f
    + [ctypes.c_void_p]  # stream
)
LIB = _build.CudaLibrary(SOURCE, "decode_mlp", {
    "decode_mlp_launch": ARGTYPES,
    "decode_mlp_smem_bytes": [ctypes.c_int],  # (d) -> bytes per block
    "decode_mlp_blocks": [ctypes.c_int],  # (f) -> d_ff blocks
})


def decode_mlp_call(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    x: (B, d), w1/w3: (d, f), w2: (f, d), all f32 contiguous on the card;
    B and f need not be multiples of the kernel's blocks.
    returns: (B, d) = (silu(x W1) * x W3) W2.
    """
    global LAUNCHES
    for name, t in (("x", x), ("w1", w1), ("w3", w3), ("w2", w2)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous matrix")
    b, d = x.shape
    f = w1.shape[1]
    if w1.shape != (d, f) or w3.shape != (d, f) or w2.shape != (f, d):
        raise ValueError(
            f"w1 {tuple(w1.shape)} w3 {tuple(w3.shape)} w2 {tuple(w2.shape)} "
            f"do not match x {tuple(x.shape)}"
        )
    smem = LIB.fn("decode_mlp_smem_bytes")(d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d={d} needs {smem} B of shared memory per block")
    part = torch.empty(
        (LIB.fn("decode_mlp_blocks")(f), b, d), dtype=torch.float32, device=x.device
    )
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    LIB.launch(
        "decode_mlp_launch", x.device,
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        part.data_ptr(), out.data_ptr(), b, d, f,
    )
    LAUNCHES += 1
    return out
