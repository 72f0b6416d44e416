"""The CUDA causal-conv1d kernel's wrapper: build, bind, validate, launch.

`csrc/conv1d_fused.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `conv1d_fused_call` takes CUDA tensors only and
raises on anything the kernel does not take; the plain version of the
same function is `ref.conv1d_ref`.  `LAUNCHES` counts the kernel's
launches.  fp32 inputs launch the fp32 instantiation
(`conv1d_fused_launch`), bf16 inputs the bf16 one
(`conv1d_fused_bf16_launch`: f32 taps, bias and SiLU, the output rounded
once); nothing else is taken.  The backward's two entry points
(`backward.py`) live in the same source and library.

The launch geometry (`Geometry`: channels per thread, threads per block,
the grid) is computed here, once per (B, L, D, row stride, alignment),
and passed to the C entry point as one `LaunchArgs` struct; the source
refuses a geometry that does not cover the work.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

MAX_THREADS = 128  # `kMaxThreads` in the source
ROWS = 8  # `kRows`: rows of a strip, one thread's

SOURCE = pathlib.Path(__file__).parent / "csrc" / "conv1d_fused.cu"


class LaunchArgs(ctypes.Structure):
    """`LaunchArgs` in the source: one launch's sizes and geometry."""

    _fields_ = [("x_row_stride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "batch", "seq", "d", "k", "silu", "vec", "threads", "n_cblocks", "n_strips")]


LIB = _build.CudaLibrary(SOURCE, "conv1d_fused", {
    # x, w, b, out, &LaunchArgs, stream
    "conv1d_fused_launch": [ctypes.c_void_p] * 6,
    "conv1d_fused_bf16_launch": [ctypes.c_void_p] * 6,
    # x, w, b, g, dx, dw, db, scratch, &LaunchArgs, stream (`backward.py`)
    "conv1d_fused_bwd_launch": [ctypes.c_void_p] * 10,
    "conv1d_fused_bwd_bf16_launch": [ctypes.c_void_p] * 10,
})
# the forward's entry point of each element type, and its wide unit (16 bytes)
ENTRY = {torch.float32: "conv1d_fused_launch", torch.bfloat16: "conv1d_fused_bf16_launch"}
WIDE = {torch.float32: 4, torch.bfloat16: 8}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's shape: each thread owns `vec` adjacent channels of one
    strip of `ROWS` rows of one sequence; a block is `threads` threads
    along the channels; the grid is (`n_strips`, `n_cblocks`, batch)."""

    vec: int
    threads: int
    n_cblocks: int
    n_strips: int
    batch: int

    @property
    def n_blocks(self) -> int:
        return self.n_strips * self.n_cblocks * self.batch

    def launch_args(self, length: int, d: int, row_stride: int, k: int,
                    silu: bool) -> LaunchArgs:
        """The C entry point's `LaunchArgs` for x (batch, length, d) with
        rows `row_stride` floats apart and K = `k` taps."""
        return LaunchArgs(row_stride, self.batch, length, d, k, int(silu), self.vec,
                          self.threads, self.n_cblocks, self.n_strips)


@functools.lru_cache(maxsize=None)
def launch_geometry(batch: int, length: int, d: int, row_stride: int,
                    aligned: bool = True, dtype: torch.dtype = torch.float32) -> Geometry:
    """The geometry for x (batch, length, d), rows `row_stride` values
    apart: 16-byte units (4 floats, or 8 bf16 values for a bf16 `dtype`)
    when d and the row stride are multiples of the unit and the tensors
    16-byte aligned, else single values; blocks of 128
    threads (fewer warps for a narrow D); one strip of `ROWS` rows per
    thread, so every L gives ceil(L / 8) strips.  At mamba2-1.3b's
    prefill waves that is 3,456 blocks (B 4, L 768) and 306 (B 2, L 129),
    several per SM.  The reference's L block `lb` is not an input: on
    the card it changes nothing."""
    if min(batch, length, d) < 1 or row_stride < d:
        raise ValueError(f"no geometry for B={batch} L={length} D={d} row={row_stride}")
    wide = WIDE[dtype]
    vec = wide if aligned and d % wide == 0 and row_stride % wide == 0 else 1
    units = -(-d // vec)
    threads = min(MAX_THREADS, -(-units // 32) * 32)
    return Geometry(vec, threads, -(-units // threads), -(-length // ROWS), batch)


@functools.lru_cache(maxsize=None)
def _launch_args(batch: int, length: int, d: int, row: int, k: int, silu: bool,
                 aligned: bool, dtype: torch.dtype = torch.float32) -> tuple:
    """(`LaunchArgs`, its address) for a shape, made once: a call passes
    one pointer, not ten ints (the cache keeps the struct alive at that
    address)."""
    geo = launch_geometry(batch, length, d, row, aligned, dtype)
    args = geo.launch_args(length, d, row, k, silu)
    return args, ctypes.addressof(args)


def cost(b: int, length: int, d: int, k: int, itemsize: int = 4) -> tuple:
    """(FLOPs, bytes) of the function the forward computes: K
    multiply-adds an output element; x read and y written once, w and the
    bias read once, at `itemsize` bytes a value."""
    return 2 * k * b * length * d, itemsize * (2 * b * length * d + k * d + d)


def conv1d_fused_call(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, activation: str
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    x: (B, L, D) f32 or bf16 on the card, channels contiguous; its rows
       may be further apart than D (a column slice of a wider activation
       is read in place).
    w: (K, D), b: (D,) contiguous on the same card in x's dtype, any K >= 1.
    returns: (B, L, D) contiguous in x's dtype, act(causal conv + b).
    """
    global LAUNCHES
    # the gradient is `ops.Conv1dFused`'s, reached through `conv1d_fused`
    _build.refuse_grad("conv1d_fused_call", "call ops.conv1d_fused, whose Conv1dFused "
                       "carries the gradient", x, w, b)
    if activation not in ("silu", "none"):
        raise ValueError(f"activation must be 'silu' or 'none', got {activation!r}")
    index = x.get_device()  # -1 on the CPU
    dtype = x.dtype if x.dtype in ENTRY else torch.float32
    for name, t, ndim in (("x", x, 3), ("w", w, 2), ("b", b, 1)):
        if (t.dtype is not dtype or index < 0 or t.get_device() != index
                or t.dim() != ndim):
            raise ValueError(
                f"{name} must be a {ndim}-d {dtype} tensor (float32 or bfloat16, as x) on "
                f"the card beside x ({x.device}), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    bsz, length, d = x.shape
    k = w.shape[0]
    if w.shape != (k, d) or b.shape != (d,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not match D={d}")
    if k < 1:
        raise ValueError(f"K={k} taps; the kernel takes K >= 1")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("w and b must be contiguous")
    row = x.stride(1)
    if x.stride(2) != 1 or row < d or (bsz > 1 and x.stride(0) != length * row):
        raise ValueError(f"x strides {x.stride()} are not (L*R, R, 1) with R >= D")
    out = torch.empty((bsz, length, d), dtype=dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr())
    _, args = _launch_args(bsz, length, d, row, k, activation == "silu",
                           not any(p % 16 for p in ptrs), dtype)
    LIB.launch(ENTRY[dtype], x.device, *ptrs, args)
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return out
