"""The CUDA decode-MLP kernel's wrapper: build, bind, validate, launch.

`csrc/decode_mlp.cu` is compiled with nvcc for sm_90a on first use
(`kernels._build`).  `decode_mlp_call` takes CUDA tensors only and raises
on anything the kernel does not take; the plain version of the same
function is `ref.decode_mlp_ref`.  `LAUNCHES` counts the kernel's
launches (one per call: the d_ff-block pass and its fixed-order
reduction of partials are launched together, by one C call).  fp32
inputs launch the fp32 instantiation (`decode_mlp_launch`), bf16 inputs
the bf16 one (`decode_mlp_bf16_launch`: units of 8 values, f32 sums and
h, the output rounded once); nothing else is taken.

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
MAX_THREADS_BF16 = 384  # `kMaxThreadsBf16`: the bf16 instances' launch bound
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
    "decode_mlp_bf16_launch": [ctypes.c_void_p] * 8,
})
# the entry point of each element type the kernel takes
ENTRY = {torch.float32: "decode_mlp_launch", torch.bfloat16: "decode_mlp_bf16_launch"}


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
               slots2: int, depth: int, esize: int = 4) -> int:
    """Dynamic shared memory of one block, `smem_bytes` in the source:
    x^T (d, rb), step 2's slot sums (2, slots1, rb, uf*vec), shared with
    step 3's (slots2, rb, d) when slots2 > 1, and h (rb, uf*vec), all f32;
    the threads' cp.async rings (2 x depth, threads, vec) of `esize`-byte
    values (4: fp32, 2: bf16)."""
    ufc = uf * vec
    red = max(2 * slots1 * rb * ufc, slots2 * rb * d if slots2 > 1 else 0)
    return 4 * (d * rb + red + rb * ufc) + 2 * depth * threads * vec * esize


@functools.lru_cache(maxsize=None)
def launch_geometry(batch: int, d: int, f: int, sm_count: int = SM_COUNT,
                    aligned: bool = True, dtype: torch.dtype = torch.float32) -> Geometry:
    """The geometry for x (batch, d), W1 (d, f): at fp32, float4 units when
    d and f are multiples of 4 and the tensors 16-byte aligned, else single
    floats; at bf16, units of 8 values (16 bytes), which need d and f
    multiples of 8 and aligned tensors (raises otherwise), and at most
    `MAX_THREADS_BF16` threads a block.  Blocks cut on grains of two 16-byte
    units (a 32-byte sector, so no sector of a weight row is read by two
    blocks); one block per SM (fewer when f has fewer grains), each an even
    share of the grains; rows of x in passes of up to 4; the deepest
    cp.async ring that fits.  Raises when the shape needs more shared
    memory than a block has."""
    if dtype == torch.bfloat16:
        if not (aligned and d % 8 == 0 and f % 8 == 0):
            raise ValueError(f"the bf16 kernel takes d and f multiples of 8 and 16-byte "
                             f"aligned tensors, got d={d}, f={f}, aligned={aligned}")
        vec, max_threads, esize = 8, MAX_THREADS_BF16, 2
    else:
        vec = 4 if aligned and d % 4 == 0 and f % 4 == 0 else 1
        max_threads, esize = MAX_THREADS, 4
    gran = 2 if vec >= 4 else 1  # `grain` in the source
    grains = -(-(f // vec) // gran)
    n_blocks = min(sm_count, grains)
    uf = gran * -(-grains // n_blocks)
    du = d // vec
    dut = min(du, max_threads)
    slots2 = max(1, min(max_threads // dut, round(TARGET_THREADS / dut)))
    t3 = slots2 * dut  # step 3's threads; the block runs a multiple of them
    threads = min(max_threads, -(-max(t3 * -(-MIN_THREADS // t3), uf) // 32) * 32)
    if uf > threads:
        raise ValueError(f"f={f} gives {uf} column units a block, over {threads} threads")
    slots1 = threads // uf
    rb = min(batch, MAX_ROWS)
    for depth in DEPTHS:
        smem = smem_bytes(d, rb, vec, threads, uf, slots1, slots2, depth, esize)
        if smem <= MAX_SMEM_BYTES:
            return Geometry(vec, rb, n_blocks, threads, uf, slots1, slots2, dut, depth,
                            smem)
    raise ValueError(f"d={d}, f={f} needs {smem} B of shared memory per block")


@functools.lru_cache(maxsize=None)
def _launch_args(batch: int, d: int, f: int, index: int, aligned: bool,
                 dtype: torch.dtype = torch.float32) -> tuple:
    """(Geometry, its `LaunchArgs`, their address) for a shape on card
    `index`, made once: a call passes one pointer, not fourteen ints (the
    cache keeps the struct alive at that address)."""
    sm_count = torch.cuda.get_device_properties(index).multi_processor_count
    geo = launch_geometry(batch, d, f, sm_count, aligned, dtype)
    args = geo.launch_args(batch, d, f)
    return geo, args, ctypes.addressof(args)


def cost(b: int, d: int, f: int, itemsize: int = 4) -> tuple:
    """(FLOPs, bytes) of the function the kernel computes: three (B, d) x
    (d, f)-sized products; W1, W3 and W2 read once, x read and y written
    once, at `itemsize` bytes a value."""
    return 2 * b * 3 * d * f, itemsize * (3 * d * f + 2 * b * d)


def decode_mlp_call(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    x: (B, d), w1/w3: (d, f), w2: (f, d), all f32 or all bf16, contiguous
    on the card; B and f need not be multiples of the kernel's blocks (at
    bf16, d and f are multiples of 8).
    returns: (B, d) = (silu(x W1) * x W3) W2 in x's dtype.
    """
    global LAUNCHES
    _build.refuse_grad("decode_mlp", "ROADMAP §1, training: the gradients still to port",
                       x, w1, w3, w2)
    index = x.get_device()  # -1 on the CPU
    dtype = x.dtype if x.dtype in ENTRY else torch.float32
    for name, t in (("x", x), ("w1", w1), ("w3", w3), ("w2", w2)):
        if (t.dtype is not dtype or index < 0 or t.get_device() != index
                or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} matrix (float32 or bfloat16, as x) on "
                f"the card beside x ({x.device}), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    b, d = x.shape
    f = w1.shape[1]
    if w1.shape != (d, f) or w3.shape != (d, f) or w2.shape != (f, d):
        raise ValueError(
            f"w1 {tuple(w1.shape)} w3 {tuple(w3.shape)} w2 {tuple(w2.shape)} "
            f"do not match x {tuple(x.shape)}"
        )
    ptrs = (x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr())
    geo, _, args = _launch_args(b, d, f, index, not any(p % 16 for p in ptrs), dtype)
    # the partials (f32) live only for this launch; the output is its own allocation
    part = torch.empty((geo.n_blocks, b, d), dtype=torch.float32, device=x.device)
    out = torch.empty((b, d), dtype=dtype, device=x.device)
    LIB.launch(ENTRY[dtype], x.device, *ptrs, part.data_ptr(), out.data_ptr(), args)
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return out
