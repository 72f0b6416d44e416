"""The CUDA conv1d backward's wrapper: validate, lay out, launch.

`conv1d_fused_bwd_call(x, w, b, g, activation=...)` returns (dx, dw, db),
the gradient of `conv1d_fused_call(x, w, b, activation=...)` for the
output gradient g.  Its plain version is `ref.conv1d_bwd_ref`.
`LAUNCHES` counts calls.  fp32 inputs launch `conv1d_fused_bwd_launch`,
an entry point of the forward's source (`csrc/conv1d_fused.cu`, built
once into `kernel.LIB`): its segment kernel and the reduction of its
partial dw / db.  bf16 inputs launch `conv1d_fused_bwd_bf16_launch`, the
source of its own `csrc/conv1d_fused_bwd_bf16.cu` (`LIB_BF16`, TMA-fed
with `flash_attention/csrc/hopper.cuh`; f32 sums, each gradient rounded
once); nothing else is taken.

fp32 geometry: the fp32 forward's (`kernel.launch_geometry`: 4 channels
a thread where D, the row stride and the pointers allow it), the rows
cut into segments of `SEG_ROWS` rows, one thread's walk; the partial
sums take a scratch tensor of batch x segments x (K + 1) x D floats.

bf16 geometry (`bf16_geometry`, K 1..8): channel slabs of `SLAB`
channels, each cut into `per_slab` blocks that walk contiguous ranges of
the slab's (sequence, `SEG_ROWS`-row segment) pairs in `CHUNK`-row
chunks, `BLOCKS_PER_SM` blocks an SM, one wave; each block sums dw / db
over its range into one partial row set, and a second kernel adds a
slab's sets in block order (dx is bitwise the segment-walk kernel's, dw
and db differ from it by their grouping).  The TMA copies need D and the
row stride multiples of 8 and 16-byte aligned tensors: other shapes run
on zero-padded copies (`_tma_operands`).  K 9..`MAX_TAPS` run the
segment-walk kernel (one thread a 32-row segment, a partial row set
each) kept in the same source (the fp32 geometry, 4 channels a
thread).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d_fused import kernel as _kernel

LAUNCHES = 0  # backward calls since import (or since a caller reset it)

SEG_ROWS = _kernel.SEG_ROWS  # `kSegRows` in the sources
MAX_TAPS = 32  # `kMaxAnyKBwd` in the sources
ENTRY = {torch.float32: "conv1d_fused_bwd_launch", torch.bfloat16: "conv1d_fused_bwd_bf16_launch"}

SOURCE_BF16 = pathlib.Path(__file__).parent / "csrc" / "conv1d_fused_bwd_bf16.cu"
# the bf16 streams' constants, shared with the forward's (`csrc/stream.cuh`:
# `kMaxTaps`, `kSlab`, `kChunk`, ...), and the backward's own
STREAM_TAPS = _kernel.STREAM_TAPS  # K up to this runs the streamed kernel
SLAB = _kernel.SLAB
CHUNK = _kernel.CHUNK
HALO_ROWS = _kernel.HALO_ROWS
STAGE_BYTES = (HALO_ROWS + 2 * CHUNK) * SLAB * 2
DX_BUFFERS = 3
BLOCKS_PER_SM = _kernel.BLOCKS_PER_SM  # `__launch_bounds__(kThreads, 3)`
STAGES = 2  # ring stages a block: 3 blocks an SM fit beside each other
SM_COUNT = _kernel.SM_COUNT  # H100 SXM; the wrapper asks the card


class BwdBf16Args(ctypes.Structure):
    """`BwdBf16Args` in the bf16 source: one launch's sizes and geometry."""

    _fields_ = [("x_row_stride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "batch", "seq", "d", "k", "silu", "n_slabs", "per_slab", "segs", "stages",
            "smem", "vec", "threads", "n_cblocks", "n_strips")]


LIB_BF16 = _build.CudaLibrary(SOURCE_BF16, "conv1d_fused_bwd_bf16", {
    # x, w, b, g, dx, dw, db, part, &BwdBf16Args, stream
    "conv1d_fused_bwd_bf16_launch": [ctypes.c_void_p] * 10,
})


def library(dtype: torch.dtype) -> _build.CudaLibrary:
    """The library of `dtype`'s entry point (read at call time, so that a
    caller may swap either for an earlier source's)."""
    return _kernel.LIB if dtype == torch.float32 else LIB_BF16


def n_segments(length: int) -> int:
    return -(-length // SEG_ROWS)


def stream_smem_bytes(stages: int) -> int:
    """Dynamic shared memory of one streamed block, `stream_smem_bytes` in
    the bf16 source: the ring, the dx chunk buffers, two mbarriers a
    stage and 1024 bytes to align the base."""
    return stages * STAGE_BYTES + DX_BUFFERS * CHUNK * SLAB * 2 + 16 * stages + 1024


@dataclasses.dataclass(frozen=True)
class Bf16Geometry(_kernel.StreamGeometry):
    """One streamed bf16 backward launch: the forward stream's slabs and
    block ranges (`kernel.StreamGeometry`), and the partial scratch its
    dw / db sums take."""

    def part_floats(self, k: int, d: int) -> int:
        """The partial scratch the source expects: K + 1 rows of d floats
        a block of a slab (each slab's blocks write their channels of the
        same `per_slab` row sets)."""
        return self.per_slab * (k + 1) * d


@functools.lru_cache(maxsize=None)
def bf16_geometry(batch: int, length: int, d: int, sm_count: int = SM_COUNT) -> Bf16Geometry:
    """The streamed kernel's geometry for x (batch, length, d): the
    forward stream's split (`kernel.slab_split`: ceil(d / SLAB) slabs, as
    many blocks a slab as `BLOCKS_PER_SM` blocks on every SM allow, one
    wave, at most one a segment), `STAGES` ring stages."""
    return Bf16Geometry(batch, *_kernel.slab_split(batch, length, d, sm_count), STAGES,
                        stream_smem_bytes(STAGES))


@functools.lru_cache(maxsize=None)
def _launch_args(batch: int, length: int, d: int, row: int, k: int, silu: bool,
                 aligned: bool) -> tuple:
    """(`LaunchArgs`, its address) for a shape, made once; `n_strips`
    carries the segment count."""
    g = _kernel.launch_geometry(batch, length, d, row, aligned)
    args = _kernel.LaunchArgs(row, batch, length, d, k, int(silu), g.vec, g.threads,
                              g.n_cblocks, n_segments(length))
    return args, ctypes.addressof(args)


@functools.lru_cache(maxsize=None)
def _bf16_launch_args(batch: int, length: int, d: int, row: int, k: int, silu: bool,
                      aligned: bool, sm_count: int = SM_COUNT) -> tuple:
    """(geometry, `BwdBf16Args`, its address) for a bf16 shape, made once:
    the streamed kernel's geometry for K <= `STREAM_TAPS` (the segment-walk
    kernel's fields zero), the segment-walk kernel's (the fp32 geometry's, 4
    channels a thread) above it."""
    if k <= STREAM_TAPS:
        g = bf16_geometry(batch, length, d, sm_count)
        args = BwdBf16Args(row, batch, length, d, k, int(silu), g.n_slabs, g.per_slab,
                           g.segs, g.stages, g.smem, 0, 0, 0, 0)
    else:
        g = _kernel.launch_geometry(batch, length, d, row, aligned)
        args = BwdBf16Args(row, batch, length, d, k, int(silu), 0, 0, 0, 0, 0, g.vec,
                           g.threads, g.n_cblocks, n_segments(length))
    return g, args, ctypes.addressof(args)


def cost(b: int, length: int, d: int, k: int, itemsize: int = 4) -> tuple:
    """(FLOPs, bytes) of the function the backward computes: 4K + 10
    operations an element of x (the forward's K multiply-adds again for
    the SiLU's input, the SiLU's derivative, dx's K taps, dw's and db's
    sums); x and g read and dx written once, w, b, dw and db once each, at
    `itemsize` bytes a value."""
    n = b * length * d
    return (4 * k + 10) * n, itemsize * (3 * n + 2 * k * d + 2 * d)


def _tma_operands(x, w, b, g):
    """The streamed kernel's operands: x, w, b, g as they are where D and
    x's row stride are multiples of 8 and every pointer 16-byte aligned;
    else zero-padded copies with D rounded up to 8 (padded channels have
    zero taps, bias and gradient, so their dpre is 0), and the width to
    cut dx, dw and db back to."""
    d = x.shape[2]
    if d % 8 == 0 and x.stride(1) % 8 == 0 and not any(
            t.data_ptr() % 16 for t in (x, w, b, g)):
        return x, w, b, g, d
    d8 = -(-d // 8) * 8
    pad = (0, d8 - d)
    return (*(torch.nn.functional.pad(t, pad).contiguous() for t in (x, w, b, g)), d)


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
    silu = activation == "silu"
    if dtype == torch.bfloat16 and k <= STREAM_TAPS:
        dx, dw, db = _stream_bf16(x, w, b, g, k, silu)
    else:
        dx = torch.empty((bsz, length, d), dtype=dtype, device=x.device)
        dw = torch.empty((k, d), dtype=dtype, device=x.device)
        db = torch.empty((d,), dtype=dtype, device=x.device)
        part = torch.empty((bsz * n_segments(length), k + 1, d), dtype=torch.float32,
                           device=x.device)
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), db.data_ptr(), part.data_ptr())
        aligned = not any(p % 16 for p in ptrs[:5] + ptrs[7:])  # the wide path's
        if dtype == torch.bfloat16:  # K > STREAM_TAPS: the segment-walk kernel
            _, _, args = _bf16_launch_args(bsz, length, d, row, k, silu, aligned)
            LIB_BF16.launch(ENTRY[dtype], x.device, *ptrs, args)
        else:
            _, args = _launch_args(bsz, length, d, row, k, silu, aligned)
            library(dtype).launch(ENTRY[dtype], x.device, *ptrs, args)
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return dx, dw, db


def _stream_bf16(x, w, b, g, k: int, silu: bool):
    """The streamed bf16 kernel (K <= STREAM_TAPS) on x, w, b, g, padded
    where the TMA copies need it; (dx contiguous, dw, db)."""
    x, w, b, g, d = _tma_operands(x, w, b, g)
    bsz, length, dp = x.shape
    geo, _, args = _bf16_launch_args(bsz, length, dp, x.stride(1), k, silu, True,
                                     _kernel.sm_count(x.get_device()))
    dx = torch.empty((bsz, length, dp), dtype=x.dtype, device=x.device)
    dw = torch.empty((k, dp), dtype=x.dtype, device=x.device)
    db = torch.empty((dp,), dtype=x.dtype, device=x.device)
    part = torch.empty(geo.part_floats(k, dp), dtype=torch.float32, device=x.device)
    LIB_BF16.launch(ENTRY[torch.bfloat16], x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
                    args)
    if dp != d:
        return dx[..., :d].contiguous(), dw[:, :d].contiguous(), db[:d].contiguous()
    return dx, dw, db
