"""The CUDA decode-MLP kernel's wrapper: build, bind, validate, launch.

`csrc/decode_mlp.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `decode_mlp_call` takes CUDA tensors only and raises
on anything the kernel does not take; the plain version of the same
function is `ref.decode_mlp_ref`.  `LAUNCHES` counts the kernel's
launches (one per call: the d_ff-block pass and its fixed-order
reduction of partials are launched together, by one C call).

The launch geometry (`Geometry`: one block per SM, each an even share of
d_ff's columns cut on 32-byte grains; threads, slots, ring depth, shared
memory) is computed here, once per (B, d, f, card, alignment), and passed
to the C entry point as one `LaunchArgs` struct; the source refuses a
geometry that does not cover the work or whose shared memory disagrees
with its layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

MAX_SMEM_BYTES = 232_448  # per-block opt-in shared memory of sm_90
SM_COUNT = 132  # H100 SXM; the wrapper asks the card
MAX_THREADS = 640  # `kMaxThreads` in the source
MAX_ROWS = 4  # `kMaxRows`: rows of x per pass over the weights
DEPTHS = (6, 2)  # rows of W1/W3 a thread keeps in flight, deepest that fits
TARGET_THREADS = 256  # step 3's threads aim here: slots x d's units
MIN_THREADS = 512  # a block runs at least this many, a multiple of step 3's

SOURCE = pathlib.Path(__file__).parent / "csrc" / "decode_mlp.cu"


class LaunchArgs(ctypes.Structure):
    """`LaunchArgs` in the source: one launch's sizes and geometry."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "d", "f", "vec", "rb", "n_blocks", "threads", "uf", "slots1",
        "slots2", "dut", "depth", "smem")]


LIB = _build.CudaLibrary(SOURCE, "decode_mlp", {
    # x, w1, w3, w2, part, out, &LaunchArgs, stream
    "decode_mlp_launch": [ctypes.c_void_p] * 8,
})


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's shape.  d_ff is cut into `n_blocks` blocks of whole
    grains (two units of 4 columns, or one of 1), at most `uf` units a block;
    step 2 runs `slots1` row slots of `uf` threads, step 3 `slots2` slots
    of `dut` threads along d's units; each thread keeps `depth` rows of W1
    and W3 (2 x `depth` of W2) in flight in its ring."""

    vec: int
    rb: int
    n_blocks: int
    threads: int
    uf: int
    slots1: int
    slots2: int
    dut: int
    depth: int
    smem: int

    def launch_args(self, batch: int, d: int, f: int) -> LaunchArgs:
        """The C entry point's `LaunchArgs` for x (batch, d), W1 (d, f)."""
        return LaunchArgs(batch, d, f, self.vec, self.rb, self.n_blocks, self.threads,
                          self.uf, self.slots1, self.slots2, self.dut, self.depth,
                          self.smem)


def smem_bytes(d: int, rb: int, vec: int, threads: int, uf: int, slots1: int,
               slots2: int, depth: int) -> int:
    """Dynamic shared memory of one block, `smem_floats` in the source:
    x^T (d, rb); step 2's slot sums (2, slots1, rb, uf*vec), shared with
    step 3's (slots2, rb, d) when slots2 > 1; h (rb, uf*vec); the threads'
    cp.async rings (2 x depth, threads, vec)."""
    ufc = uf * vec
    red = max(2 * slots1 * rb * ufc, slots2 * rb * d if slots2 > 1 else 0)
    return 4 * (d * rb + red + rb * ufc + 2 * depth * threads * vec)


@functools.lru_cache(maxsize=None)
def launch_geometry(batch: int, d: int, f: int, sm_count: int = SM_COUNT,
                    aligned: bool = True) -> Geometry:
    """The geometry for x (batch, d), W1 (d, f): float4 units when d and f
    are multiples of 4 and the tensors 16-byte aligned, else single floats;
    blocks cut on grains of two float4 units (a 32-byte sector, so no sector
    of a weight row is read by two blocks); one block per SM (fewer when f
    has fewer grains), each an even share of the grains; rows of x in
    passes of up to 4; the deepest cp.async ring that fits.  Raises when
    the shape needs more shared memory than a block has."""
    vec = 4 if aligned and d % 4 == 0 and f % 4 == 0 else 1
    gran = 2 if vec == 4 else 1  # `grain` in the source
    grains = -(-(f // vec) // gran)
    n_blocks = min(sm_count, grains)
    uf = gran * -(-grains // n_blocks)
    du = d // vec
    dut = min(du, MAX_THREADS)
    slots2 = max(1, min(MAX_THREADS // dut, round(TARGET_THREADS / dut)))
    t3 = slots2 * dut  # step 3's threads; the block runs a multiple of them
    threads = min(MAX_THREADS, -(-max(t3 * -(-MIN_THREADS // t3), uf) // 32) * 32)
    if uf > threads:
        raise ValueError(f"f={f} gives {uf} column units a block, over {threads} threads")
    slots1 = threads // uf
    rb = min(batch, MAX_ROWS)
    for depth in DEPTHS:
        smem = smem_bytes(d, rb, vec, threads, uf, slots1, slots2, depth)
        if smem <= MAX_SMEM_BYTES:
            return Geometry(vec, rb, n_blocks, threads, uf, slots1, slots2, dut, depth,
                            smem)
    raise ValueError(f"d={d}, f={f} needs {smem} B of shared memory per block")


@functools.lru_cache(maxsize=None)
def _launch_args(batch: int, d: int, f: int, index: int, aligned: bool) -> tuple:
    """(Geometry, its `LaunchArgs`, their address) for a shape on card
    `index`, made once: a call passes one pointer, not fourteen ints (the
    cache keeps the struct alive at that address)."""
    sm_count = torch.cuda.get_device_properties(index).multi_processor_count
    geo = launch_geometry(batch, d, f, sm_count, aligned)
    args = geo.launch_args(batch, d, f)
    return geo, args, ctypes.addressof(args)


def decode_mlp_call(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    x: (B, d), w1/w3: (d, f), w2: (f, d), all f32 contiguous on the card;
    B and f need not be multiples of the kernel's blocks.
    returns: (B, d) = (silu(x W1) * x W3) W2.
    """
    global LAUNCHES
    index = x.get_device()  # -1 on the CPU
    for name, t in (("x", x), ("w1", w1), ("w3", w3), ("w2", w2)):
        if (t.dtype is not torch.float32 or index < 0 or t.get_device() != index
                or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 matrix on the card beside x "
                f"({x.device}), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    b, d = x.shape
    f = w1.shape[1]
    if w1.shape != (d, f) or w3.shape != (d, f) or w2.shape != (f, d):
        raise ValueError(
            f"w1 {tuple(w1.shape)} w3 {tuple(w3.shape)} w2 {tuple(w2.shape)} "
            f"do not match x {tuple(x.shape)}"
        )
    ptrs = (x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr())
    geo, _, args = _launch_args(b, d, f, index, not any(p % 16 for p in ptrs))
    # the partials live only for this launch; the output is its own allocation
    part = torch.empty((geo.n_blocks, b, d), dtype=torch.float32, device=x.device)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    LIB.launch("decode_mlp_launch", x.device, *ptrs, part.data_ptr(), out.data_ptr(), args)
    LAUNCHES += 1
    return out
