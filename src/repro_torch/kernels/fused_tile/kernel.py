"""The CUDA tile kernel's wrapper: build, bind, validate, launch.

`csrc/fused_tile.cu` is compiled with nvcc for sm_90a into a shared
library with a plain C entry point, on first use, into
``build/repro_torch/`` at the repository root, and bound with ctypes
(`kernels._build`).  Nothing is built or loaded when this module is
imported: the CPU tests import it without a CUDA toolkit.

`fused_tile_call` takes CUDA tensors only and raises on anything the
kernel does not take; the plain PyTorch version of the same function is
`matrix.matrix_tile_conv`.  `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.core import transforms
from repro_torch.kernels import _build
from repro_torch.kernels.fused_tile.matrix import basis

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

# per-block opt-in shared memory of sm_90 (H100)
MAX_SMEM_BYTES = 232_448
SM_SMEM_BYTES = 233_472  # one SM's shared memory (228 KB), its blocks' sum
SM_COUNT = 132
THREADS = 256  # threads per block, `kThreads` in the source
NA_CHOICES = (8, 16, 24, 28, 32)  # pixels per inverse thread, instantiated
_MAX_R = 8  # tiles per block the chooser considers
_MAX_EP_OPS = 16  # the epilogue rides in one 64-bit word, 4 bits per op
_RELU = 15

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_tile.cu"

# `fused_tile_launch`'s C signature, in order
ARGTYPES = (
    [ctypes.c_void_p] * 7  # xp, rhs, fwd_t, inv_t, biases, out, part
    + [ctypes.c_int] * 19  # batch, h_pad, w_pad, c_in, c_out, t, t_out,
    #                        planes, s_mix, groups, n_tiles_h, n_tiles_w,
    #                        r, ns, sc, n_split, na, stage_rhs, n_ops
    + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]  # ep_code, smem, stream
)

LIB = _build.CudaLibrary(SOURCE, "fused_tile", {"fused_tile_launch": ARGTYPES})


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's work split: R tiles x a slab of `ns` output channels x
    1/`n_split` of the S transform points per block, S streamed in chunks
    of `sc` points, `na` output pixels per inverse thread; the chunk's
    rhs slice staged in shared memory (`stage_rhs`) or read through L1."""

    r: int
    ns: int
    sc: int
    n_split: int
    na: int
    stage_rhs: bool = True

    def grid(self, n_tiles: int, c_out: int) -> Tuple[int, int, int]:
        return (-(-n_tiles // self.r), -(-c_out // self.ns), self.n_split)

    def blocks(self, n_tiles: int, c_out: int) -> int:
        gx, gy, gz = self.grid(n_tiles, c_out)
        return gx * gy * gz

    def block_work(self, block: Tuple[int, int, int], n_tiles: int, c_out: int,
                   s_mix: int) -> Tuple[range, range, range]:
        """(tiles, output channels, transform points) that block (x, y, z)
        of the grid computes -- the kernel's own mapping, masked at the
        ragged ends."""
        bx, by, bz = block
        s_per = -(-s_mix // self.n_split)
        return (
            range(bx * self.r, min(n_tiles, (bx + 1) * self.r)),
            range(by * self.ns, min(c_out, (by + 1) * self.ns)),
            range(bz * s_per, min(s_mix, (bz + 1) * s_per)),
        )


def _round4(x: int) -> int:
    return (x + 3) & ~3


def pick_na(spec: transforms.TileKernelSpec, r: int, ns: int) -> Optional[int]:
    """Output pixels per inverse thread: the (tile, channel) pairs of a
    block take THREADS // (r*ns) thread groups, which share the T'^2
    pixels; None when the pairs exceed the block or no instantiated
    count covers the pixels."""
    if r * ns > THREADS:
        return None
    need = -(-spec.t_out * spec.t_out // (THREADS // (r * ns)))
    return next((na for na in NA_CHOICES if na >= need), None)


def smem_bytes(spec: transforms.TileKernelSpec, c_in: int, c_out: int,
               groups: int, geo: Geometry) -> int:
    """Dynamic shared memory of one block, the layout `fused_tile_launch`
    computes (which refuses a launch whose bytes disagree): the R input
    patches, two buffers each of the chunk's fwd rows, inv columns and rhs
    slice, and one each of the chunk's U and Z."""
    tt, p = spec.t * spec.t, spec.planes
    pst = _round4(tt * c_in)
    pst += 8 if pst % 32 == 0 else 0
    an = THREADS // (geo.r * geo.ns) * geo.na
    kg, kd, nc = p * (c_in // groups), p * c_in, p * geo.ns
    floats = (
        geo.r * pst
        + 2 * (tt * _round4(p * geo.sc) + p * geo.sc * an
               + geo.stage_rhs * _round4(geo.sc * kg * nc))
        + _round4(geo.sc * kd * _round4(geo.r))
        + _round4(geo.sc * geo.r * nc)
    )
    return 4 * floats


def buffer_bytes(spec: transforms.TileKernelSpec, r: int, c_in: int, c_out: int) -> int:
    """The least shared memory a block of R tiles needs (its input patches
    dominate): a one-channel slab, one point per chunk, no split, priced
    by `smem_bytes`."""
    na = pick_na(spec, r, 1)
    if na is None:
        return 1 << 62
    return smem_bytes(spec, c_in, c_out, 1, Geometry(r=r, ns=1, sc=1, n_split=1, na=na))


def fit_r(spec: transforms.TileKernelSpec, r: int, c_in: int, c_out: int) -> int:
    """The largest R <= `r` for which a block of R tiles fits one block's
    shared memory.  R only groups independent tiles into a task, so
    lowering it never changes the output.  Raises when even R=1 does not
    fit."""
    r = max(1, r)
    while r > 1 and buffer_bytes(spec, r, c_in, c_out) > MAX_SMEM_BYTES:
        r -= 1
    if buffer_bytes(spec, r, c_in, c_out) > MAX_SMEM_BYTES:
        raise ValueError(
            f"{spec.family} T={spec.t} tile buffer for {c_in}->{c_out} "
            f"channels needs {buffer_bytes(spec, 1, c_in, c_out)} B of "
            f"shared memory at R=1, over the {MAX_SMEM_BYTES} B a block has"
        )
    return r


def geometry_features(spec: transforms.TileKernelSpec, n_tiles: int, c_in: int,
                      c_out: int, groups: int, geo: Geometry) -> Tuple[float, ...]:
    """The terms of `geometry_cost`, from the kernel's loop structure:

    I, a block's instructions per thread (the forward's, mix's and
    inverse's FMAs and shared-memory loads, per item of 4 rows x 1-2
    columns, the staging copies), summed over its chunks; `load`, the
    blocks the busiest SM runs; `conc`, how many of them share it at once
    (shared memory, registers; the card overlaps at most two well).
    Terms: issue (load * I), latency (load / conc * I: one block's chain
    when few warps share the SM), barriers (load / conc * chunks), the
    split's reduction, the unstaged mix's waits on L2, a part-filled
    second group of 4 tiles in the mix, and 1."""
    p, tt, to2 = spec.planes, spec.t * spec.t, spec.t_out ** 2
    r, ns, sc = geo.r, geo.ns, geo.sc
    s_blk = -(-spec.s_mix // geo.n_split)
    chunks = -(-s_blk // sc)
    kg, nc = p * (c_in // groups), p * ns
    rows = p * sc
    fq = r * c_in
    # two columns per item where every thread still gets one (as the source)
    f_pairs = -(-fq // 2) * -(-rows // 4) >= THREADS
    f_items = -(-fq // (2 if f_pairs else 1)) * -(-rows // 4)
    f_cost = tt * (1 + (2 if f_pairs else 1) * 5)
    m_pairs = groups == 1 and sc * -(-r // 4) * -(-nc // 2) >= THREADS
    m_items = sc * -(-r // 4) * -(-nc // (2 if m_pairs else 1))
    m_cost = kg * (1 + (2 if m_pairs else 1) * 5)
    inv = rows * (1 + geo.na // 4 + geo.na)
    stage = (p * tt * sc + p * sc * THREADS // (r * ns) * geo.na
             + geo.stage_rhs * sc * kg * nc) / THREADS * 6
    per_chunk = (-(-f_items // THREADS) * f_cost + -(-m_items // THREADS) * m_cost
                 + inv + stage)
    instr = chunks * per_chunk + r * tt * c_in / THREADS * 6
    smem = smem_bytes(spec, c_in, c_out, groups, geo)
    regs = 48 + 1.5 * p * geo.na
    per_sm = max(1, min(SM_SMEM_BYTES // (smem + 1024), int(65536 // (THREADS * regs))))
    blocks = geo.blocks(n_tiles, c_out)
    load = -(-blocks // SM_COUNT)
    conc = max(1, min(per_sm, load, 2))
    reduce = (geo.n_split > 1) * (geo.n_split + 1) * p * n_tiles * to2 * c_out / (SM_COUNT * THREADS)
    # an unstaged mix waits on L2 about once per 8 unrolled rhs loads
    l2_waits = (not geo.stage_rhs) * chunks * -(-m_items // THREADS) * -(-kg // 8)
    # a second, part-filled group of 4 tiles in the mix
    ragged_rows = (r > 4) * chunks * -(-m_items // THREADS) * m_cost
    return (load * instr, load / conc * instr, load / conc * chunks, reduce,
            load / conc * l2_waits, load / conc * ragged_rows, 1.0)


# ms per unit of each `geometry_features` term: a non-negative least-squares
# fit (weighted by 1/time) to the device times `sweep.py` measured over all
# 6,846 geometries of the six served shapes (NVIDIA H100 80GB HBM3, 700 W).
# The issue term fits to 0: at these sizes latency, not issue, sets the time.
_COST_THETA = (0.0, 3.36e-06, 4.41e-04, 8.99e-05, 8.09e-05, 2.90e-06, 2.52e-02)


def geometry_cost(spec: transforms.TileKernelSpec, n_tiles: int, c_in: int,
                  c_out: int, groups: int, geo: Geometry) -> float:
    """Model time of a launch, ms: `geometry_features` weighted by
    `_COST_THETA`."""
    f = geometry_features(spec, n_tiles, c_in, c_out, groups, geo)
    return float(sum(a * b for a, b in zip(f, _COST_THETA)))


def candidate_geometries(spec: transforms.TileKernelSpec, n_tiles: int,
                         c_in: int, c_out: int, groups: int, r_max: int):
    """Every geometry the kernel takes for this shape that fits a block:
    R <= min(r_max, 8), slabs of C', C'/2, C'/4, C'/8 (rounded up), chunks
    of 1..16 points, S split across blocks only for FFT (P=2: the split
    adds fixed-order partial sums; Winograd keeps one chain)."""
    splits = (1, 2, 3, 4, 6, 8) if spec.planes == 2 else (1,)
    slabs = sorted({-(-c_out // d) for d in (1, 2, 4, 8)}, reverse=True)
    for r in range(1, max(1, min(r_max, _MAX_R, n_tiles)) + 1):
        for ns in slabs:
            na = pick_na(spec, r, ns)
            if na is None:
                continue
            for n_split in splits:
                for sc in (16, 12, 8, 7, 6, 4, 2, 1):
                    if sc * n_split > spec.s_mix and sc > 1:
                        continue
                    for stage in (True, False):
                        geo = Geometry(r=r, ns=ns, sc=sc, n_split=n_split, na=na,
                                       stage_rhs=stage)
                        if smem_bytes(spec, c_in, c_out, groups, geo) <= MAX_SMEM_BYTES:
                            yield geo


_GEOMETRY: dict = {}  # launch_geometry's picks, per shape


def launch_geometry(spec: transforms.TileKernelSpec, n_tiles: int, c_in: int,
                    c_out: int, groups: int = 1, r_max: int = _MAX_R) -> Geometry:
    """The candidate of least `geometry_cost` (ties: fewer blocks, then
    larger R), chosen once per shape and process.  Raises when no
    geometry fits a block."""
    key = (spec.family, spec.t, spec.k, n_tiles, c_in, c_out, groups, r_max)
    if key not in _GEOMETRY:
        _GEOMETRY[key] = _least_cost(spec, n_tiles, c_in, c_out, groups, r_max)
    return _GEOMETRY[key]


def _least_cost(spec, n_tiles, c_in, c_out, groups, r_max) -> Geometry:
    best = min(
        candidate_geometries(spec, n_tiles, c_in, c_out, groups, r_max),
        key=lambda g: (geometry_cost(spec, n_tiles, c_in, c_out, groups, g),
                       g.blocks(n_tiles, c_out), -g.r, -g.sc),
        default=None,
    )
    if best is None:
        raise ValueError(
            f"no tile-kernel geometry fits {c_in}->{c_out} channels of "
            f"{spec.family} T={spec.t} in {MAX_SMEM_BYTES} B"
        )
    return best


def encode_epilogue(ep_ops: Tuple, n_bias: int) -> Tuple[int, int]:
    """`ElementwiseOps.kernel_form` tags -> (n_ops, 64-bit op word): 4
    bits per op, in order; ``_RELU`` for relu, else the bias row."""
    if len(ep_ops) > _MAX_EP_OPS:
        raise ValueError(f"epilogue of {len(ep_ops)} ops > {_MAX_EP_OPS}")
    word = 0
    for i, op in enumerate(ep_ops):
        if op[0] == "relu":
            code = _RELU
        elif op[0] == "bias" and 0 <= int(op[1]) < min(n_bias, _RELU):
            code = int(op[1])
        else:
            raise ValueError(f"epilogue op {op!r} not expressible in the kernel")
        word |= code << (4 * i)
    return len(ep_ops), word


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_shape(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


_BASIS_T: dict = {}  # (family, t, k, device) -> (fwd^T, inv^T)


def transposed_basis(spec: transforms.TileKernelSpec, device):
    """The spec's basis matrices as the kernel stages them: fwd^T (T*T,
    P*S) and inv^T (P*S, T'^2), contiguous f32 on `device`, made once per
    process."""
    key = (spec.family, spec.t, spec.k, str(torch.device(device)))
    hit = _BASIS_T.get(key)
    if hit is None:
        kf, ki = basis(spec, device)
        hit = (kf.t().contiguous(), ki.t().contiguous())
        _BASIS_T[key] = hit
    return hit


@dataclasses.dataclass(frozen=True)
class _LaunchPlan:
    """Everything a launch needs beyond the three input pointers, worked
    out and checked once per call signature."""

    geo: Geometry
    out_shape: Tuple[int, ...]
    part_numel: int
    basis_ptrs: Tuple[int, int]
    ints: Tuple[int, ...]  # batch .. n_ops, then the epilogue word and smem


_PLANS: dict = {}  # call signature -> _LaunchPlan


def _launch_plan(xp, rhs, biases, spec, n_tiles_h, n_tiles_w, r, groups, ep_ops,
                 geometry) -> _LaunchPlan:
    b, h_pad, w_pad, c_in = xp.shape
    t, t_out, p, s = spec.t, spec.t_out, spec.planes, spec.s_mix
    if groups < 1 or c_in % groups or rhs.ndim != 4:
        raise ValueError(f"bad groups {groups} / rhs {tuple(rhs.shape)}")
    c_out = rhs.shape[1] * rhs.shape[3] // p
    if r < 1:
        raise ValueError(f"r must be >= 1, got {r}")
    _check_shape("xp", xp, (b, n_tiles_h * t_out + spec.k - 1,
                            n_tiles_w * t_out + spec.k - 1, c_in))
    _check_shape("rhs", rhs, (s, groups, p * c_in // groups, p * c_out // groups))
    _check_shape("biases", biases, (biases.shape[0], c_out))
    n_ops, word = encode_epilogue(ep_ops, biases.shape[0])
    n_tiles = b * n_tiles_h * n_tiles_w
    geo = geometry or launch_geometry(spec, n_tiles, c_in, c_out, groups, r)
    if pick_na(spec, geo.r, geo.ns) is None or geo.na < pick_na(spec, geo.r, geo.ns):
        raise ValueError(f"geometry {geo} does not cover the tile")
    smem = smem_bytes(spec, c_in, c_out, groups, geo)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"geometry {geo} needs {smem} B of shared memory")
    kf_t, ki_t = transposed_basis(spec, xp.device)
    return _LaunchPlan(
        geo=geo,
        out_shape=(b, n_tiles_h * t_out, n_tiles_w * t_out, c_out),
        part_numel=geo.n_split * p * n_tiles * t_out * t_out * c_out if geo.n_split > 1 else 0,
        basis_ptrs=(kf_t.data_ptr(), ki_t.data_ptr()),
        ints=(b, h_pad, w_pad, c_in, c_out, t, t_out, p, s, groups, n_tiles_h,
              n_tiles_w, geo.r, geo.ns, geo.sc, geo.n_split, geo.na,
              int(geo.stage_rhs), n_ops, word, smem),
    )


def fused_tile_call(
    xp: torch.Tensor,
    rhs: torch.Tensor,
    biases: torch.Tensor,
    *,
    spec: transforms.TileKernelSpec,
    n_tiles_h: int,
    n_tiles_w: int,
    r: int,
    groups: int = 1,
    ep_ops: tuple = (),
    geometry: Optional[Geometry] = None,
) -> torch.Tensor:
    """Launch the CUDA tile kernel on the current stream.

    xp:  (B, H_pad, W_pad, C) f32 padded input, H_pad = nH*T' + K - 1,
         W_pad = nW*T' + K - 1.
    rhs: (S, g, P*C/g, P*C'/g) f32 packed right-hand matrices
         (`TileKernelSpec.pack_rhs`).
    biases: (n_bias, C') f32 rows referenced by ("bias", idx) epilogue
         ops (pass one zero row when unused).
    r:   the plan's tiles per task; the launch groups at most that many
         tiles per block (`launch_geometry`), unless `geometry` names the
         split outright.
    returns: (B, nH*T', nW*T', C') assembled output tiles.

    Shapes, the geometry and the launch arguments are worked out once per
    call signature; every call checks device, type and contiguity.
    """
    global LAUNCHES
    for name, t in (("xp", xp), ("rhs", rhs), ("biases", biases)):
        _check(name, t)
    if not (xp.device == rhs.device == biases.device):
        raise ValueError("xp, rhs and biases must be on one device")
    key = (xp.shape, rhs.shape, biases.shape, xp.device, spec.family, spec.t,
           spec.k, n_tiles_h, n_tiles_w, r, groups, ep_ops, geometry)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _launch_plan(xp, rhs, biases, spec, n_tiles_h, n_tiles_w, r,
                            groups, ep_ops, geometry)
        _PLANS[key] = plan
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=xp.device)
    part = (torch.empty((plan.part_numel,), dtype=torch.float32, device=xp.device)
            if plan.part_numel else out)
    LIB.launch(
        "fused_tile_launch", xp.device,
        xp.data_ptr(), rhs.data_ptr(), *plan.basis_ptrs, biases.data_ptr(),
        out.data_ptr(), part.data_ptr(), *plan.ints,
    )
    LAUNCHES += 1
    return out
