"""The flash backward kernel's schedule and bound, on the CPU.

`backward.work_list` is the list of items the CUDA kernel walks (one
block an item): it must cover every (q tile, kv tile) pair of the band
exactly once per role -- dK/dV items over their group's q heads, dQ items
over their q head -- with an item for every block, and be sorted longest
first; at fp32's 32-row tile (bitwise the list it was) and at bf16's
64-row warpgroup tile, at every head-dim pair.  `backward.flops`, the FLOP count `chip_smoke.py`'s bound uses,
must equal a brute-force count of `ref.band_mask`.  Exact integer
comparisons throughout.  `step_clocks.instrument` must still find its
anchors in the kernel source (the measurement copy is made from it).
"""

import hashlib

import pytest
import torch

from repro_torch.kernels.flash_attention import backward as bk
from repro_torch.kernels.flash_attention import step_clocks
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import band_mask

T = bk.TILE
BF16 = torch.bfloat16

SHAPES = {  # (b, hq, hkv, sq, sk, hd, causal, window)
    "gemma3-global": (4, 4, 1, 1024, 1024, 256, True, 0),
    "gemma3-local-w512": (4, 4, 1, 1024, 1024, 256, True, 512),
    "ragged-S77-g1": (2, 4, 4, 77, 77, 64, True, 0),
    "ragged-S77-w40-g4": (2, 4, 1, 77, 77, 80, True, 40),
    "rows-that-see-no-key-Sq200-Sk50-w40-g2": (1, 2, 1, 200, 50, 64, True, 40),
    "keys-no-row-sees-Sq50-Sk200-g1": (1, 2, 2, 50, 200, 16, True, 0),
    "non-causal-Sq77-Sk256-g2": (1, 2, 1, 77, 256, 128, False, 0),
    "non-causal-w24-Sq100-Sk130-g1": (1, 4, 4, 100, 130, 32, False, 24),
    # seamless-m4t-medium's cross attention: training (Sq 512) and prefill
    # (Sq 128) over 1024 frames, MHA hd 64, no mask
    "seamless-cross-Sq512-Sk1024": (4, 16, 16, 512, 1024, 64, False, 0),
    "seamless-cross-Sq128-Sk1024": (4, 16, 16, 128, 1024, 64, False, 0),
}


def _band_tiles(sq, sk, causal, window, tile=T) -> torch.Tensor:
    """(q tiles, kv tiles) int: 1 where the tile pair holds a band pair."""
    ok = band_mask(sq, sk, causal=causal, window=window, device="cpu")
    nq, nk = -(-sq // tile), -(-sk // tile)
    pad = torch.zeros(nq * tile, nk * tile, dtype=torch.bool)
    pad[:sq, :sk] = ok
    return pad.reshape(nq, tile, nk, tile).any(3).any(1).to(torch.int64)


def _check_cover(items, b, hq, hkv, sq, sk, causal, window, tile):
    """Every band tile pair one step of exactly one item of each role, an
    item for every block."""
    g = hq // hkv
    band = _band_tiles(sq, sk, causal, window, tile)
    nq, nk = band.shape
    steps = {bk.DKDV: torch.zeros(b, hq, nq, nk, dtype=torch.int64),
             bk.DQ: torch.zeros(b, hq, nq, nk, dtype=torch.int64)}
    blocks = {bk.DKDV: [], bk.DQ: []}
    for role, bh, blk, lo, hi in items:
        assert 0 <= lo <= hi and hi <= (nq if role == bk.DKDV else nk)
        blocks[role].append((bh, blk))
        if role == bk.DKDV:  # key block blk of kv head hk: q tiles [lo, hi) of its g q heads
            bi, hk = divmod(bh, hkv)
            steps[role][bi, hk * g:(hk + 1) * g, lo:hi, blk] += 1
        else:  # q block blk of q head h: kv tiles [lo, hi)
            bi, h = divmod(bh, hq)
            steps[role][bi, h, blk, lo:hi] += 1
    # one item for every block, also where its band is empty
    assert sorted(blocks[bk.DKDV]) == [(bh, kb) for bh in range(b * hkv) for kb in range(nk)]
    assert sorted(blocks[bk.DQ]) == [(bh, qb) for bh in range(b * hq) for qb in range(nq)]
    want = band.expand(b, hq, nq, nk)
    assert torch.equal(steps[bk.DKDV], want)
    assert torch.equal(steps[bk.DQ], want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_work_list_covers_every_band_tile_pair_once_per_role(name):
    b, hq, hkv, sq, sk, hd, causal, window = SHAPES[name]
    _check_cover(bk.work_list(b, hq, hkv, sq, sk, hd, causal, window), b, hq, hkv, sq, sk,
                 causal, window, T)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_work_list_is_sorted_longest_first(name):
    b, hq, hkv, sq, sk, hd, causal, window = SHAPES[name]
    items = bk.work_list(b, hq, hkv, sq, sk, hd, causal, window)
    costs = [bk.item_steps(it, hq // hkv) * bk.PRODUCTS[it[0]] for it in items]
    assert costs == sorted(costs, reverse=True)
    assert list(items) == sorted(items, key=lambda it: (-costs[items.index(it)], it[:3]))


def test_work_list_at_gemma3_global_layer():
    """128 dK/dV items (4 batches x 32 key blocks, key block 0 the longest:
    4 heads x 32 q tiles) and 512 dQ items; the list starts with the four
    key-block-0 items."""
    items = bk.work_list(*SHAPES["gemma3-global"])
    assert sum(it[0] == bk.DKDV for it in items) == 128
    assert sum(it[0] == bk.DQ for it in items) == 512
    assert items[:4] == tuple((bk.DKDV, bh, 0, 0, 32) for bh in range(4))
    assert bk.item_steps(items[0], 4) == 128


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bound_flops_equal_a_brute_force_count_of_the_band(name):
    b, hq, hkv, sq, sk, hd, causal, window = SHAPES[name]
    pairs = int(band_mask(sq, sk, causal=causal, window=window, device="cpu").sum())
    assert bk.band_pairs(sq, sk, causal, window) == pairs
    assert bk.flops(b, hq, sq, sk, hd, causal, window) == 5 * 2 * hd * b * hq * pairs


def test_bound_flops_at_gemma3_training_layers():
    """The figures PERF.md's bounds rest on: 524,800 band pairs a head at
    the global layer and 393,472 at the local one (window 512)."""
    assert bk.band_pairs(1024, 1024, True, 0) == 524_800
    assert bk.band_pairs(1024, 1024, True, 512) == 393_472
    assert bk.flops(4, 4, 1024, 1024, 256, True, 0) == 21_495_808_000
    assert bk.flops(4, 4, 1024, 1024, 256, True, 512) == 16_116_613_120


def test_bound_flops_at_split_head_dims():
    """Three products at q/k's hd (S, dK, dQ) and two at v's vd (dP, dV): at
    deepseek-v3's MLA training layer (B 4, 128 heads, S 1024, causal, hd
    192, vd 128) 447 GFLOP; vd = hd gives the five products of 2 hd."""
    pairs = bk.band_pairs(1024, 1024, True, 0)
    assert bk.flops(4, 128, 1024, 1024, 192, True, 0, vd=128) == (
        2 * (3 * 192 + 2 * 128) * 4 * 128 * pairs) == 447_112_806_400
    assert bk.flops(4, 128, 1023, 1023, 56, True, 0) == 5 * 2 * 56 * 4 * 128 * 523_776
    assert bk.flops(2, 4, 77, 77, 64, True, 0, vd=64) == bk.flops(2, 4, 77, 77, 64, True, 0)


@pytest.mark.parametrize("hd,vd", [(192, 128), (56, 56), (56, None)])
def test_work_list_takes_the_split_and_padded_head_dims(hd, vd):
    """MLA's (192, 128) and the MTP block's 56 have work lists, the same
    items as any head dim's at the same shape (the tile is 32 at every
    head dim)."""
    key = (2, 4, 2, 77, 77)
    assert bk.work_list(*key, hd, True, 24, vd) == bk.work_list(*key, 64, True, 24)


@pytest.mark.parametrize("hd,vd", [(128, 192), (192, 192), (48, 48), (56, 64)])
def test_work_list_refuses_a_pair_with_no_instantiation(hd, vd):
    with pytest.raises(ValueError, match="no work list"):
        bk.work_list(1, 2, 2, 8, 8, hd, True, 0, vd)


def test_device_items_encode_role_block_and_band():
    key = SHAPES["rows-that-see-no-key-Sq200-Sk50-w40-g2"]
    rows = bk._device_items(key, torch.device("cpu"))
    assert rows.dtype == torch.int32
    assert rows.tolist() == [[role | blk << 1, bh, lo, hi]
                             for role, bh, blk, lo, hi in bk.work_list(*key)]
    assert bk._device_items(key, torch.device("cpu")) is rows  # made once


@pytest.mark.parametrize("name", ["seamless-cross-Sq512-Sk1024", "seamless-cross-Sq128-Sk1024"])
def test_device_items_at_non_causal_sq_other_than_sk(name):
    """The memoised device copy under the wrapper's key (vd appended) at
    cross attention's shapes: every dK/dV item walks all Sq / 32 q tiles
    and every dQ item all 32 kv tiles; Sq 128 and Sq 512 get lists of
    their own."""
    key = SHAPES[name] + (64,)
    b, hq, _, sq, sk = key[:5]
    rows = bk._device_items(key, torch.device("cpu"))
    assert rows.tolist() == [[role | blk << 1, bh, lo, hi]
                             for role, bh, blk, lo, hi in bk.work_list(*key)]
    dkdv = rows[rows[:, 0] % 2 == bk.DKDV]
    dq = rows[rows[:, 0] % 2 == bk.DQ]
    assert len(dkdv) == b * hq * sk // T and len(dq) == b * hq * sq // T
    assert (dkdv[:, 2] == 0).all() and (dkdv[:, 3] == sq // T).all()
    assert (dq[:, 2] == 0).all() and (dq[:, 3] == sk // T).all()
    other = "seamless-cross-Sq128-Sk1024" if sq == 512 else "seamless-cross-Sq512-Sk1024"
    assert bk._device_items(SHAPES[other] + (64,), torch.device("cpu")).shape != rows.shape


@pytest.mark.parametrize("shape", [(1, 2, 1, 8, 8, 48, True, 0), (1, 3, 2, 8, 8, 64, True, 0)])
def test_work_list_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError, match="no work list"):
        bk.work_list(*shape)


def test_step_clocks_instruments_the_committed_source():
    text = bk.SOURCE.read_text()
    marked = step_clocks.instrument(text)
    assert marked.count("MARK(") == 1 + len(step_clocks.PARTS)  # the macro and one a part
    assert "bwd_clocks" in marked and "mma_rate_launch" in marked
    assert "MARK(" not in text and "clock64" not in text


# the fp32 work list is bitwise what it was before the bf16 kernel's own
# tile: SHA-256 of repr(work_list(*shape)) under the fp32 tile, items
FP32_LISTS = {
    (4, 4, 1, 1024, 1024, 256, True, 0): ("f54b9ff97dc7d59f", 640),
    (4, 4, 1, 1024, 1024, 256, True, 512): ("f14dc6e950082b5c", 640),
    (2, 4, 1, 77, 77, 80, True, 40): ("524afdc019bdb982", 30),
    (1, 2, 1, 200, 50, 64, True, 40): ("531f1de02a98e7a1", 16),
    (1, 2, 1, 77, 256, 128, False, 0): ("f7ac9bfb6d4001f8", 14),
    (4, 128, 128, 1024, 1024, 192, True, 0, 128): ("4c8d8a0736b01c40", 32768),
    (4, 128, 128, 1023, 1023, 56, True, 0): ("4c8d8a0736b01c40", 32768),
}


@pytest.mark.parametrize("shape", list(FP32_LISTS), ids=str)
def test_fp32_work_list_is_unchanged(shape):
    items = bk.work_list(*shape)
    digest = hashlib.sha256(repr(items).encode()).hexdigest()[:16]
    assert (digest, len(items)) == FP32_LISTS[shape]
    assert bk.work_list(*shape[:8], shape[8] if len(shape) > 8 else None,
                        torch.float32) == items
    assert bk.TILES[torch.float32] == T == 32 and bk.STEP_PRODUCTS[torch.float32] == bk.PRODUCTS


# the bf16 kernel's lists: (b, hq, hkv, sq, sk, causal, window) at every
# head-dim pair -- GQA (g 1, 2, 4, 8), windows with rows that see no key,
# Sq != Sk, and Sq or Sk of 1, 63, 65, 127, 129 (no multiple of the tile)
BF16_SHAPES = {
    "gemma3-global": (4, 4, 1, 1024, 1024, True, 0),
    "gemma3-local-w512": (4, 4, 1, 1024, 1024, True, 512),
    "ragged-S77-w40-g4": (2, 4, 1, 77, 77, True, 40),
    "rows-that-see-no-key-Sq200-Sk50-w40-g2": (1, 2, 1, 200, 50, True, 40),
    "keys-no-row-sees-Sq50-Sk200-g1": (1, 2, 2, 50, 200, True, 0),
    "non-causal-Sq77-Sk256-g2": (1, 2, 1, 77, 256, False, 0),
    "Sq65-Sk127-causal-g8": (1, 8, 1, 65, 127, True, 0),
    "Sq129-Sk63-w24-g4": (1, 4, 1, 129, 63, False, 24),
    "Sq1-Sk129-g1": (2, 2, 2, 1, 129, False, 0),
    "Sq127-Sk1-causal-g2": (1, 4, 2, 127, 1, True, 0),
    "seamless-cross-Sq512-Sk1024": (4, 16, 16, 512, 1024, False, 0),
}


@pytest.mark.parametrize("hd,vd", HEAD_DIMS)
@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_bf16_work_list_covers_every_band_tile_pair_once_per_role(name, hd, vd):
    b, hq, hkv, sq, sk, causal, window = BF16_SHAPES[name]
    items = bk.work_list(b, hq, hkv, sq, sk, hd, causal, window, vd, BF16)
    _check_cover(items, b, hq, hkv, sq, sk, causal, window, bk.TILES[BF16])


@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_bf16_work_list_is_sorted_longest_first(name):
    b, hq, hkv, sq, sk, causal, window = BF16_SHAPES[name]
    items = bk.work_list(b, hq, hkv, sq, sk, 64, causal, window, None, BF16)
    products = bk.STEP_PRODUCTS[BF16]
    costs = [bk.item_steps(it, hq // hkv) * products[it[0]] for it in items]
    assert costs == sorted(costs, reverse=True)
    assert list(items) == sorted(items, key=lambda it: (-costs[items.index(it)], it[:3]))


def _kv_head(it, hq, hkv):
    """batch * hkv + kv head of an item (a dQ item's q head // g)."""
    role, bh = it[0], it[1]
    return bh if role == bk.DKDV else bh // hq * hkv + bh % hq // (hq // hkv)


# (b, hq, hkv, sq, sk, hd, vd, causal): the bf16 training layers whose K
# and V outgrow the L2 (their list grouped by kv head) and those whose do
# not (one list, longest first)
L2_SHAPES = {
    "gemma3-global": ((4, 4, 1, 1024, 1024, 256, 256, True), False),
    "seamless-decoder-self": ((4, 16, 16, 512, 512, 64, 64, True), False),
    "seamless-encoder": ((4, 16, 16, 1024, 1024, 64, 64, False), False),
    "moonshot": ((4, 16, 16, 1024, 1024, 128, 128, True), False),
    "deepseek-mla": ((4, 128, 128, 1024, 1024, 192, 128, True), True),
    "deepseek-mtp": ((4, 128, 128, 1023, 1023, 56, 56, True), True),
}


@pytest.mark.parametrize("name", sorted(L2_SHAPES))
def test_bf16_work_list_groups_heads_where_they_outgrow_the_l2(name):
    """Grouped by (batch, kv head) in order where `head_major` -- both roles
    of a head side by side -- and longest first (ties in (role, head,
    block) order) within each group, else over the whole list; the fp32
    list never grouped."""
    (b, hq, hkv, sq, sk, hd, vd, causal), grouped = L2_SHAPES[name]
    assert bk.head_major(b, hkv, sk, hd, vd, BF16) == grouped
    assert not bk.head_major(b, hkv, sk, hd, vd, torch.float32)
    items = bk.work_list(b, hq, hkv, sq, sk, hd, causal, 0, vd, BF16)
    heads = [_kv_head(it, hq, hkv) for it in items]
    products = bk.STEP_PRODUCTS[BF16]
    groups = [[it for it in items if _kv_head(it, hq, hkv) == h] for h in range(b * hkv)]
    if grouped:
        assert heads == sorted(heads) and all({it[0] for it in g} == {0, 1} for g in groups)
    for group in groups if grouped else [list(items)]:
        costs = [bk.item_steps(it, hq // hkv) * products[it[0]] for it in group]
        assert costs == sorted(costs, reverse=True)
        assert group == sorted(group, key=lambda it: (-costs[group.index(it)], it[:3]))
    _check_cover(items, b, hq, hkv, sq, sk, causal, 0, bk.TILES[BF16])


def test_bf16_work_list_at_gemma3_global_layer():
    """64-row tiles: 64 dK/dV items (4 batches x 16 key blocks, key block 0
    the longest: 4 heads x 16 q tiles) and 256 dQ items; the list starts
    with the four key-block-0 items, and the bf16 steps count five and four
    products."""
    items = bk.work_list(*SHAPES["gemma3-global"], None, BF16)
    assert bk.TILES[BF16] == 64 and bk.STEP_PRODUCTS[BF16] == {bk.DKDV: 5, bk.DQ: 4}
    assert sum(it[0] == bk.DKDV for it in items) == 64
    assert sum(it[0] == bk.DQ for it in items) == 256
    assert items[:4] == tuple((bk.DKDV, bh, 0, 0, 16) for bh in range(4))
    assert bk.item_steps(items[0], 4) == 64


def test_bf16_device_items_are_their_own_list():
    """The wrapper's key ends in vd and the element type: bf16 and fp32 get
    lists of their own, each memoised."""
    key = SHAPES["rows-that-see-no-key-Sq200-Sk50-w40-g2"] + (64,)
    rows = bk._device_items(key + (BF16,), torch.device("cpu"))
    assert rows.tolist() == [[role | blk << 1, bh, lo, hi]
                             for role, bh, blk, lo, hi in bk.work_list(*key, BF16)]
    assert bk._device_items(key + (BF16,), torch.device("cpu")) is rows
    assert rows.shape != bk._device_items(key + (torch.float32,), torch.device("cpu")).shape


def test_work_list_refuses_an_element_type_with_no_kernel():
    with pytest.raises(ValueError, match="no work list"):
        bk.work_list(1, 2, 2, 8, 8, 64, True, 0, None, torch.float16)
