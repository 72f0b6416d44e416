"""The bf16 conv1d forward's TMA stream (`conv1d_fused_fwd_bf16.cu`), on
the CPU.

The kernel runs only on the card (`tests/test_torch_kernel_cuda.py`,
`chip_smoke.py`); what its wrapper decides before a launch is held here:
the stream's geometry walks every (sequence, row) of every channel
exactly once in one wave of blocks, a block's shared memory lets 3 share
an SM, the route picks the stream by shape alone (aligned K <= 8) and
PR 25's kernel for every other bf16 shape, and the entry point's ctypes
argument types and launch-args struct match its C declaration.
"""

import ctypes
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d_fused import backward as conv_bwd
from repro_torch.kernels.conv1d_fused import kernel as conv_kernel
from test_torch_conv1d_bwd_bf16 import HEADER, OPT_IN, STREAM, _c_argtypes, _c_struct_fields

# (B, L, D): the served prefill waves and the training slice of mamba2-1.3b
# and zamba2-7b's xBC, and ragged lengths
CONV = {"mamba2-wave1": (4, 768, 4352), "zamba2-wave1": (4, 768, 7296),
        "mamba2-wave2": (2, 129, 4352), "mamba2-train": (4, 1024, 4352),
        "L1": (1, 1, 8), "L5": (3, 5, 64), "L129-B1": (1, 129, 256),
        "L301": (2, 301, 512), "L777": (2, 777, 104), "L1024-D7296": (4, 1024, 7296)}
SOURCE_TEXT = _build.source_text(conv_kernel.SOURCE_BF16).decode()  # with `stream.cuh`


def _pieces(g, block: int, length: int):
    """The pieces block `block` of a slab walks, as `piece_at` in
    `stream.cuh` cuts its range: (sequence, first chunk, end chunk)."""
    chunks = -(-length // conv_kernel.CHUNK)
    q, q1 = g.seg_range(block)
    while q < q1:
        b, s0 = divmod(q, g.segs)
        s1 = min(g.segs, s0 + (q1 - q))
        yield b, 2 * s0, min(2 * s1, chunks)
        q += s1 - s0


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv1d_fwd_bf16_walks_every_row_and_channel_once(name):
    """Every (sequence, row) of a slab in exactly one chunk of one block's
    pieces, each piece inside one sequence; the slabs cover every channel
    once; one wave of blocks at `BLOCKS_PER_SM` an SM."""
    b, length, d = CONV[name]
    g = conv_kernel.stream_geometry(b, length, d)
    assert g.n_slabs * conv_kernel.SLAB >= d > (g.n_slabs - 1) * conv_kernel.SLAB
    assert g.segs == -(-length // conv_kernel.SEG_ROWS)
    assert conv_kernel.SEG_ROWS == 2 * conv_kernel.CHUNK
    assert g.n_blocks <= conv_kernel.BLOCKS_PER_SM * conv_kernel.SM_COUNT
    rows = torch.zeros((b, length), dtype=torch.int32)
    for blk in range(g.per_slab):
        pieces = list(_pieces(g, blk, length))
        assert pieces  # no block without work
        for seq, j0, j1 in pieces:
            assert 0 <= seq < b and j1 > j0
            rows[seq, j0 * conv_kernel.CHUNK:j1 * conv_kernel.CHUNK] += 1
    assert bool((rows == 1).all())


@pytest.mark.parametrize("name,n_slabs,per_slab,spans", [
    ("mamba2-wave1", 17, 23, {4, 5}), ("zamba2-wave1", 29, 13, {7, 8}),
    ("mamba2-wave2", 17, 10, {1}), ("mamba2-train", 17, 23, {5, 6}),
])
def test_conv1d_fwd_bf16_served_geometry(name, n_slabs, per_slab, spans):
    """The served and trained shapes: D 4352 is 17 slabs exactly (no
    channel block a quarter full), 23 blocks a slab fill 391 of the 396
    slots; each block walks 4-8 segments (128-256 rows) at the waves of
    768 rows and one segment at wave 2's 129."""
    b, length, d = CONV[name]
    g = conv_kernel.stream_geometry(b, length, d)
    assert (g.n_slabs, g.per_slab, g.stages) == (n_slabs, per_slab, conv_kernel.STREAM_STAGES)
    assert {q1 - q0 for q0, q1 in map(g.seg_range, range(g.per_slab))} == spans


def test_conv1d_fwd_bf16_shared_memory_fits_three_blocks_an_sm():
    """A block's ring, output buffers, barriers and alignment slack, as the
    source computes them; 3 blocks (and the 1 KB each reserves) fit the
    SM's 228 KB, one under the 227 KB a block may have."""
    smem = conv_kernel.fwd_smem_bytes(conv_kernel.STREAM_STAGES)
    stage = (conv_kernel.HALO_ROWS + conv_kernel.CHUNK) * conv_kernel.SLAB * 2
    assert smem == (conv_kernel.STREAM_STAGES * stage
                    + conv_kernel.OUT_BUFFERS * conv_kernel.CHUNK * conv_kernel.SLAB * 2
                    + 16 * conv_kernel.STREAM_STAGES + 1024)
    assert conv_kernel.BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024 and smem <= 227 * 1024
    assert conv_kernel.stream_geometry(4, 768, 4352).smem == smem


def test_conv1d_fwd_bf16_constants_mirror_the_source():
    for line in (f"constexpr int kMaxTaps = {conv_kernel.STREAM_TAPS};",
                 f"constexpr int kSlab = {conv_kernel.SLAB};",
                 f"constexpr int kChunk = {conv_kernel.CHUNK};",
                 f"constexpr int kSegRows = {conv_kernel.SEG_ROWS};",
                 f"constexpr int kHaloRows = {conv_kernel.HALO_ROWS};",
                 f"constexpr int kMaxStages = {conv_kernel.STREAM_STAGES};",
                 f"constexpr int kBlocksPerSm = {conv_kernel.BLOCKS_PER_SM};",
                 f"constexpr int kOutBuffers = {conv_kernel.OUT_BUFFERS};",
                 "return stages * kStageBytes + kOutBuffers * kRowsBytes + 16 * stages + 1024;"):
        assert line in SOURCE_TEXT, line
    # the backward reads the same constants (one header)
    assert (conv_bwd.SLAB, conv_bwd.CHUNK, conv_bwd.SEG_ROWS, conv_bwd.STREAM_TAPS) == (
        conv_kernel.SLAB, conv_kernel.CHUNK, conv_kernel.SEG_ROWS, conv_kernel.STREAM_TAPS)


def test_stream_and_backward_share_the_range_split():
    """One split for both streams: the backward's geometry is the
    forward's slabs and ranges (`slab_split`), with its own ring."""
    for b, length, d in CONV.values():
        f = conv_kernel.stream_geometry(b, length, d)
        g = conv_bwd.bf16_geometry(b, length, d)
        assert (f.n_slabs, f.per_slab, f.segs) == (g.n_slabs, g.per_slab, g.segs)
        assert [f.seg_range(i) for i in range(f.per_slab)] == [
            g.seg_range(i) for i in range(g.per_slab)]
    for src in (conv_kernel.SOURCE_BF16, conv_bwd.SOURCE_BF16):
        text = src.read_text()
        assert '#include "stream.cuh"' in text
        assert "block_range(kb, total, a.per_slab)" in text and "piece_at(q, q1, a.segs" in text
        assert "struct Piece" not in text and "constexpr int kSlab" not in text


@pytest.mark.parametrize("d,row,k,aligned,stream", [
    (4352, 8512, 4, True, True),  # mamba2's xBC in place
    (7296, 14576, 4, True, True),  # zamba2's
    (512, 1024, 1, True, True), (512, 1024, 8, True, True), (8, 8, 3, True, True),
    (71, 200, 4, False, False),  # a slice at column 65: neither D nor the base aligned
    (256, 256, 9, True, False),  # K past the stream's taps
    (4352, 8516, 4, True, False),  # rows 8516 values apart: no 16-byte row stride
    (100, 104, 4, True, False),  # D not a multiple of 8
    (512, 1024, 4, False, False),  # a pointer off 16 bytes
])
def test_conv1d_bf16_route_is_decided_by_shape(d, row, k, aligned, stream):
    assert conv_kernel.takes_stream(d, row, k, aligned) is stream


def test_conv1d_bf16_route_alignment_as_the_wrapper_reads_it():
    """The wrapper's `aligned` for the served slice (column 4096 of 8512:
    8 KB in) and for a slice at column 65 (130 bytes in)."""
    wide = torch.zeros((2, 3, 8512), dtype=torch.bfloat16)
    assert wide.data_ptr() % 16 == 0 and wide[..., 4096:].data_ptr() % 16 == 0
    assert wide[..., 65:136].data_ptr() % 16 != 0
    call = conv_kernel.conv1d_fused_call.__code__.co_names
    assert "takes_stream" in call and "STREAM_ENTRY" in call and "ENTRY" in call


def test_conv1d_fwd_bf16_ctypes_binding_matches_the_c_signature():
    entry = conv_kernel.STREAM_ENTRY
    assert _c_argtypes(conv_kernel.SOURCE_BF16, entry) == list(
        conv_kernel.LIB_BF16.entry_points[entry])
    assert list(conv_kernel.LIB_BF16.entry_points) == [entry]
    assert conv_kernel.LIB_BF16.source == conv_kernel.SOURCE_BF16


def test_conv1d_fwd_bf16_launch_args_mirror_the_source():
    want = [(n, ctypes.c_longlong if t == "long long" else ctypes.c_int)
            for n, t in _c_struct_fields(conv_kernel.SOURCE_BF16, "FwdBf16Args")]
    assert list(conv_kernel.FwdBf16Args._fields_) == want


@pytest.mark.parametrize("k,silu", [(1, False), (4, True), (8, True)])
def test_conv1d_fwd_bf16_launch_args_are_memoised(k, silu):
    """`_stream_args` fills the struct from `stream_geometry` once a shape:
    the same object, at the same address, on a second call."""
    g, args, addr = conv_kernel._stream_args(4, 768, 4352, 8512, k, silu, 132)
    again = conv_kernel._stream_args(4, 768, 4352, 8512, k, silu, 132)
    assert again[1] is args and again[2] == addr
    assert (args.x_row_stride, args.batch, args.seq, args.d, args.k, args.silu) == (
        8512, 4, 768, 4352, k, int(silu))
    assert (args.n_slabs, args.per_slab, args.segs, args.stages, args.smem) == (
        g.n_slabs, g.per_slab, g.segs, g.stages, g.smem)


def test_conv1d_fwd_bf16_source_streams_by_tma():
    """x comes by TMA on the ring's mbarriers and y leaves by TMA store
    (`hopper.cuh`'s stream section, through `stream.cuh`); no thread loads
    global memory itself; the build hashes both headers with the source;
    the chain is the fp32 design's, in the same order."""
    src = conv_kernel.SOURCE_BF16
    text = src.read_text()
    assert "hopper::mbar_wait(" in text and "hopper::mbar_expect(" in text
    assert "hopper::tma_load3(" in text and "hopper::tma_store3(" in text
    assert "__ldg(" not in text and "cp.async.cg" not in text
    assert _build.source_text(src) == (src.read_bytes() + STREAM.read_bytes()
                                       + HEADER.read_bytes() + OPT_IN.read_bytes())
    chain = ("acc = fmaf(xw[i][v], taps[i][v], acc);", "acc += bv[v];",
             "if (a.silu) acc = acc * (1.f / (1.f + expf(-acc)));")
    old = conv_kernel.SOURCE.read_text()
    assert "acc = fmaf(win[j + i][v], taps[i][v], acc);" in old
    assert "if (a.silu) acc = acc * (1.f / (1.f + expf(-acc)));" in old
    for part in chain:
        assert part in text, part
    assert re.search(r"__float2bfloat16_rn\(v\[0\]\)", text)


def test_the_kept_bf16_entry_stays_in_the_fp32_source():
    """PR 25's bf16 forward stays for the shapes the stream does not take,
    in `conv1d_fused.cu`'s library, under its own entry."""
    assert conv_kernel.ENTRY[torch.bfloat16] == "conv1d_fused_bf16_launch"
    assert 'extern "C" int conv1d_fused_bf16_launch(' in conv_kernel.SOURCE.read_text()
    assert conv_kernel.STREAM_ENTRY not in conv_kernel.LIB.entry_points


def test_conv1d_fwd_bf16_geometry_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="no geometry"):
        conv_kernel.stream_geometry(2, 0, 64)
