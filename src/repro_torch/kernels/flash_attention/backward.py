"""The CUDA flash-attention backward kernel's wrapper: build, bind,
validate, schedule, launch.

`csrc/flash_attention_bwd.cu` (fp32) and `csrc/flash_attention_bwd_bf16.cu`
(bf16, on warpgroup `wgmma`, with `csrc/hopper.cuh`) are compiled with
nvcc for sm_90a on first use (`kernels._build`).
`flash_attention_bwd_call` takes CUDA tensors only and raises on
anything the kernel does not take; the plain version of the same
function is `ref.flash_attention_bwd_ref`.  `LAUNCHES` counts the
wrapper's calls that launched the kernel (each launches the source's two
kernels: delta, then the main kernel).  fp32 inputs launch the fp32
kernel (`flash_attention_bwd_launch`, `LIB`, split-TF32), bf16 inputs
the bf16 one (`flash_attention_bwd_bf16_launch`, `LIB_BF16`: bf16 P for
dV, the gradients rounded once to bf16), as `kernel.ENTRY` selects the
forward's; nothing else is taken.

The main kernel runs one block per item of `work_list`: a dK/dV item
(`TILES[dtype]` keys of one batch and kv head, over its group's q heads:
32 at fp32, 64 at bf16) or a dQ item (as many q rows of one batch and q
head), each with the band of tiles it walks.  The list is built here, in
plain Python that the CPU tests hold against the band mask, memoised per
shape and element type and copied to the card once per shape and device.

Like the forward, the kernel addresses every tensor by (batch, head,
sequence) strides with the head dim contiguous: the model's transposed
views are read in place, dO is copied once only when its head dim is
not contiguous or it is not 16-byte aligned, and the gradients come back
in q's, k's and v's memory layouts.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    CHECKED,
    HEAD_DIMS,
    _check,
    band_pairs,
    check_aligned,
    checked,
    head_major,
    signature,
)

LAUNCHES = 0  # wrapper calls that launched the kernel since import (or a reset)

# each kernel's kB: keys of a dK/dV item and q rows of a dQ item (and of
# their steps), at every hd: the fp32 kernel's mma.sync tiles, the bf16
# kernel's 64-row warpgroup tiles
TILES = {torch.float32: 32, torch.bfloat16: 64}
TILE = TILES[torch.float32]
DKDV, DQ = 0, 1  # item roles
# products a tile step does: S, dP, dV, dK for a dK/dV item and S, dP, dQ
# for a dQ item; at bf16 dK and dQ take two each (dS as bf16 hi and lo)
STEP_PRODUCTS = {torch.float32: {DKDV: 4, DQ: 3}, torch.bfloat16: {DKDV: 5, DQ: 4}}
PRODUCTS = STEP_PRODUCTS[torch.float32]


SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention_bwd.cu"
SOURCE_BF16 = SOURCE.with_name("flash_attention_bwd_bf16.cu")
# `flash_attention_bwd_launch`'s C signature, in order (the stream is appended)
ARGTYPES = (
    [ctypes.c_void_p] * 11  # q, k, v, o, lse, dO, dq, dk, dv, delta scratch, work list
    + [ctypes.c_int] * 8  # items, batch, hq, hkv, sq, sk, hd, vd
    + [ctypes.c_longlong] * 24  # (b, h, s) strides of q, k, v, o, dO, dq, dk, dv
    + [ctypes.c_int] * 2  # causal, window
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
LIB = _build.CudaLibrary(SOURCE, "flash_attention_bwd", {"flash_attention_bwd_launch": ARGTYPES})
LIB_BF16 = _build.CudaLibrary(SOURCE_BF16, "flash_attention_bwd_bf16",
                              {"flash_attention_bwd_bf16_launch": ARGTYPES})
# the entry point of each element type the kernel takes
ENTRY = {torch.float32: "flash_attention_bwd_launch",
         torch.bfloat16: "flash_attention_bwd_bf16_launch"}


def library(dtype: torch.dtype) -> _build.CudaLibrary:
    """The library of `dtype`'s entry point (read at call time, so that a
    caller may swap `LIB` for an earlier source's)."""
    return LIB if dtype == torch.float32 else LIB_BF16

Item = Tuple[int, int, int, int, int]  # (role, batch * heads + head, block, lo, hi)


def _tiles(lo: int, hi: int, tile: int) -> Tuple[int, int]:
    """The `tile`-row tiles that hold rows [lo, hi), as [first, end); (0, 0)
    when the range is empty."""
    return (lo // tile, -(-hi // tile)) if hi > lo else (0, 0)


def item_steps(item: Item, group: int) -> int:
    """Tile steps of one item: its band of tiles, once per q head of the
    group for a dK/dV item."""
    role, _, _, lo, hi = item
    return (hi - lo) * (group if role == DKDV else 1)


@functools.lru_cache(maxsize=64)
def work_list(
    b: int, hq: int, hkv: int, sq: int, sk: int, hd: int, causal: bool, window: int,
    vd: Optional[int] = None, dtype: torch.dtype = torch.float32,
) -> Tuple[Item, ...]:
    """The main kernel's items for `dtype`'s kernel, longest first.

    A dK/dV item (DKDV, b * hkv + kv head, key block, lo, hi) walks q
    tiles [lo, hi) of each of its group's q heads; a dQ item (DQ, b * hq
    + q head, q block, lo, hi) walks kv tiles [lo, hi).  Each range is
    exactly the tiles whose rows (or keys) can see a key (or row) of the
    item's block under `ref.band_mask`, so every (q tile, kv tile) pair
    of the band is one step of exactly one item of each role.  Every
    block has an item, also when its range is empty (it writes zeros).
    Sorted by tile steps times `STEP_PRODUCTS[dtype]` a step, longest
    first, ties in (role, head, block) order -- where `head_major`, within
    each (batch, kv head), the (batch, kv heads) in that order; the tile is
    `TILES[dtype]` at every head dim (`hd`, and v's `vd`, hd when not
    given, are checked, not used).
    """
    vd = hd if vd is None else vd
    if ((hd, vd) not in HEAD_DIMS or hq % hkv or min(b, hq, hkv, sq, sk) < 1
            or dtype not in TILES):
        raise ValueError(f"no work list for b {b}, hq {hq}, hkv {hkv}, sq {sq}, sk {sk}, "
                         f"hd {hd}, vd {vd}, {dtype}")
    tile, products = TILES[dtype], STEP_PRODUCTS[dtype]
    items = []
    for kb in range(-(-sk // tile)):
        k0, k1 = kb * tile, min(kb * tile + tile, sk) - 1  # the block's first and last key
        r_lo = k0 if causal else 0  # rows that see one of its keys: [r_lo, r_hi)
        r_hi = min(sq, k1 + window) if window > 0 else sq
        lo, hi = _tiles(r_lo, r_hi, tile)
        items += [(DKDV, bh, kb, lo, hi) for bh in range(b * hkv)]
    for qb in range(-(-sq // tile)):
        r0, r1 = qb * tile, min(qb * tile + tile, sq) - 1  # the block's first and last row
        k_lo = max(0, r0 - window + 1) if window > 0 else 0  # keys it sees: [k_lo, k_hi)
        k_hi = min(sk, r1 + 1) if causal else sk
        lo, hi = _tiles(k_lo, k_hi, tile)
        items += [(DQ, bh, qb, lo, hi) for bh in range(b * hq)]
    group = hq // hkv

    def order(it: Item) -> tuple:
        return (-item_steps(it, group) * products[it[0]], it[:3])

    def kv_head(it: Item) -> int:  # batch * hkv + kv head
        return it[1] if it[0] == DKDV else it[1] // hq * hkv + it[1] % hq // group

    grouped = head_major(b, hkv, sk, hd, vd, dtype)
    items.sort(key=(lambda it: (kv_head(it),) + order(it)) if grouped else order)
    return tuple(items)


def flops(b: int, hq: int, sq: int, sk: int, hd: int, causal: bool, window: int,
          vd: Optional[int] = None) -> int:
    """FLOPs of the function the backward computes: five products a band
    pair, per (batch, q head) -- three of 2 hd FLOPs (S, dK, dQ) and two of
    2 vd (dP, dV), vd = hd when not given.  The kernel does seven (S and dP
    again in its dQ items) and computes whole 32 x 32 tiles at the band's
    edge (the bf16 kernel nine, with dK's and dQ's hi and lo, on 64 x 64
    tiles); a bound counts only these."""
    vd = hd if vd is None else vd
    return 2 * (3 * hd + 2 * vd) * b * hq * band_pairs(sq, sk, causal, window)


def cost(b: int, hq: int, hkv: int, sq: int, sk: int, hd: int, vd: int, *, causal: bool,
         window: int, itemsize: int = 4) -> tuple:
    """(FLOPs, bytes) of the function the backward computes: `flops`, and
    q, k, v, o, dO read once and dq, dk, dv written once at `itemsize`
    bytes a value, with the f32 lse read once."""
    q, o = b * hq * sq * hd, b * hq * sq * vd
    k, v = b * hkv * sk * hd, b * hkv * sk * vd
    n_bytes = itemsize * (2 * q + 2 * (k + v) + 2 * o) + 4 * b * hq * sq
    return flops(b, hq, sq, sk, hd, causal, window, vd=vd), n_bytes


@functools.lru_cache(maxsize=64)
def _device_items(key: tuple, device: torch.device) -> torch.Tensor:
    """`work_list(*key)` as the kernel reads it, (n, 4) int32 rows of
    (role | block << 1, head, lo, hi), copied to `device` once per key
    (the kernel only reads it); the wrapper's key ends in vd and the
    element type."""
    rows = [(role | blk << 1, bh, lo, hi) for role, bh, blk, lo, hi in work_list(*key)]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _aligned(t: torch.Tensor) -> bool:
    per16 = 16 // t.element_size()  # elements in 16 bytes
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:3]))


def flash_attention_bwd_call(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream.

    q: (B, Hq, Sq, hd); o, do: (B, Hq, Sq, vd); k: (B, Hkv, Sk, hd); v:
    (B, Hkv, Sk, vd), all f32 or all bf16 on the card, any (batch, head,
    sequence) strides with the head dim contiguous; lse: the forward
    kernel's f32 (B, Hq, Sq) log-sum-exp.  Hq % Hkv == 0, (hd, vd) in `HEAD_DIMS`, scale q's
    hd^-0.5, any Sq and Sk (masks by index, as the forward).
    returns: (dq, dk, dv) in q's, k's and v's memory layouts.
    """
    global LAUNCHES
    dev, dtype = q.device, q.dtype
    sig = signature(q, k, v, o, lse, do)
    if sig in CHECKED and do.data_ptr() % 16 == 0:
        check_aligned(q, k, v, o)
        b, hq, sq, hd = q.shape
        hkv, sk, vd = k.shape[1], k.shape[2], v.shape[3]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    else:
        if dtype not in ENTRY:
            raise ValueError(f"q must be float32 or bfloat16, got {dtype}")
        if do.device == dev and do.dtype == dtype and do.ndim == 4 and not _aligned(do):
            do = do.contiguous()
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            _check(name, t, dev, dtype)
        b, hq, sq, hd = q.shape
        hkv, sk, vd = k.shape[1], k.shape[2], v.shape[3]
        if tuple(k.shape) != (b, hkv, sk, hd) or tuple(v.shape) != (b, hkv, sk, vd):
            raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                             f"{tuple(q.shape)}")
        if tuple(o.shape) != (b, hq, sq, vd) or tuple(do.shape) != (b, hq, sq, vd):
            raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} do not match q "
                             f"{tuple(q.shape)} and v {tuple(v.shape)}")
        if hq % hkv:
            raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
        if (hd, vd) not in HEAD_DIMS:
            raise ValueError(f"head dims (q/k {hd}, v {vd}) are not one of the kernel's "
                             f"instantiations {HEAD_DIMS}")
        if (lse.device != dev or lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
                or not lse.is_contiguous()):
            raise ValueError(f"lse must be the forward's contiguous f32 (B, Hq, Sq) on {dev}")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
            _check(name, t, dev, dtype)
        checked(signature(q, k, v, o, lse, do))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    items = _device_items((b, hq, hkv, sq, sk, hd, bool(causal), int(window), vd, dtype), dev)
    library(dtype).launch(
        ENTRY[dtype], dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        items.data_ptr(), items.shape[0], b, hq, hkv, sq, sk, hd, vd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        int(causal), int(window), hd ** -0.5,
    )
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return dq, dk, dv
