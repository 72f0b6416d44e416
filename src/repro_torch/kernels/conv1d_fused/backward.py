"""The CUDA conv1d backward's wrapper: validate, lay out, launch.

`conv1d_fused_bwd_call(x, w, b, g, activation=...)` returns (dx, dw, db),
the gradient of `conv1d_fused_call(x, w, b, activation=...)` for the
output gradient g, from the `conv1d_fused_bwd_launch` entry point of the
forward's source (`csrc/conv1d_fused.cu`, built once into
`kernel.LIB`).  Its plain version is `ref.conv1d_bwd_ref`.  `LAUNCHES`
counts calls (each is the segment kernel and the reduction of its
partial dw / db).  fp32 inputs launch `conv1d_fused_bwd_launch`, bf16
inputs `conv1d_fused_bwd_bf16_launch` (f32 sums, each gradient rounded
once to bf16); nothing else is taken.

The geometry is the fp32 forward's (`kernel.launch_geometry`: channels
per thread, threads, channel blocks) at both dtypes: 4 channels a thread
where D, the row stride and the pointers allow it (for bf16 the width
picked on the card from the 8, 4 and 1 its source takes, by
`python -m repro_torch.kernels.conv1d_fused.compare --bwd-widths`;
PERF.md), with the rows cut into segments of `SEG_ROWS` rows, one
thread's walk; the partial sums take a scratch tensor of batch x
segments x (K + 1) x D floats.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d_fused import kernel as _kernel

LAUNCHES = 0  # backward calls since import (or since a caller reset it)

SEG_ROWS = 32  # `kSegRows` in the source
MAX_TAPS = 32  # `kMaxAnyKBwd` in the source
ENTRY = {torch.float32: "conv1d_fused_bwd_launch", torch.bfloat16: "conv1d_fused_bwd_bf16_launch"}


def n_segments(length: int) -> int:
    return -(-length // SEG_ROWS)


@functools.lru_cache(maxsize=None)
def _launch_args(batch: int, length: int, d: int, row: int, k: int, silu: bool,
                 aligned: bool) -> tuple:
    """(`LaunchArgs`, its address) for a shape, made once; `n_strips`
    carries the segment count."""
    g = _kernel.launch_geometry(batch, length, d, row, aligned)
    args = _kernel.LaunchArgs(row, batch, length, d, k, int(silu), g.vec, g.threads,
                              g.n_cblocks, n_segments(length))
    return args, ctypes.addressof(args)


def cost(b: int, length: int, d: int, k: int, itemsize: int = 4) -> tuple:
    """(FLOPs, bytes) of the function the backward computes: 4K + 10
    operations an element of x (the forward's K multiply-adds again for
    the SiLU's input, the SiLU's derivative, dx's K taps, dw's and db's
    sums); x and g read and dx written once, w, b, dw and db once each, at
    `itemsize` bytes a value."""
    n = b * length * d
    return (4 * k + 10) * n, itemsize * (3 * n + 2 * k * d + 2 * d)


def conv1d_fused_bwd_call(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor, *, activation: str
):
    """Launch the backward on the current stream.

    x, w, b: as `kernel.conv1d_fused_call` takes them (x's rows may be
    further apart than D), all f32 or all bf16; g: (B, L, D) contiguous in
    x's dtype on the same card.  K <= MAX_TAPS.  Returns dx (B, L, D)
    contiguous, dw (K, D), db (D,) in x's dtype.
    """
    global LAUNCHES
    _build.refuse_grad("conv1d_fused_bwd", "it is Conv1dFused's backward", x, w, b, g)
    if activation not in ("silu", "none"):
        raise ValueError(f"activation must be 'silu' or 'none', got {activation!r}")
    index = x.get_device()  # -1 on the CPU
    dtype = x.dtype if x.dtype in ENTRY else torch.float32
    for name, t, ndim in (("x", x, 3), ("w", w, 2), ("b", b, 1), ("g", g, 3)):
        if t.dtype is not dtype or index < 0 or t.get_device() != index or t.dim() != ndim:
            raise ValueError(
                f"{name} must be a {ndim}-d {dtype} tensor (float32 or bfloat16, as x) on "
                f"the card beside x ({x.device}), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    bsz, length, d = x.shape
    k = w.shape[0]
    if w.shape != (k, d) or b.shape != (d,) or g.shape != x.shape:
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} / g {tuple(g.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"K={k} taps; the backward takes 1 <= K <= {MAX_TAPS}")
    if not (w.is_contiguous() and b.is_contiguous() and g.is_contiguous()):
        raise ValueError("w, b and g must be contiguous")
    row = x.stride(1)
    if x.stride(2) != 1 or row < d or (bsz > 1 and x.stride(0) != length * row):
        raise ValueError(f"x strides {x.stride()} are not (L*R, R, 1) with R >= D")
    dx = torch.empty((bsz, length, d), dtype=dtype, device=x.device)
    dw = torch.empty((k, d), dtype=dtype, device=x.device)
    db = torch.empty((d,), dtype=dtype, device=x.device)
    part = torch.empty((bsz * n_segments(length), k + 1, d), dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), part.data_ptr())
    vec_ptrs = ptrs[:5] + ptrs[7:]  # the wide path reads and writes these
    _, args = _launch_args(bsz, length, d, row, k, activation == "silu",
                           not any(p % 16 for p in vec_ptrs))
    _kernel.LIB.launch(ENTRY[dtype], x.device, *ptrs, args)
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return dx, dw, db
