"""The causal-conv1d wrapper's launch geometry, on the CPU.

The kernel runs only on the card (`tests/test_torch_kernel_cuda.py`,
`chip_smoke.py`); what its wrapper computes before a launch, once per
shape, is checked here: the vector width, the blocks, the strips, and
that they cover every (b, l, c) of the output exactly once.
"""

import inspect

import pytest
import torch

from repro_torch.kernels.conv1d_fused import backward as conv1d_backward
from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

D_XBC, WIDTH = 4352, 8512  # mamba2-1.3b's xBC slice of its in-projection
SHAPES = {
    # name: (B, L, D, row stride, 16-byte aligned)
    "mamba2-wave1": (4, 768, D_XBC, WIDTH, True),
    "mamba2-wave2": (2, 129, D_XBC, WIDTH, True),
    "D73": (3, 300, 73, 73, True),
    "slice-at-offset-65": (2, 50, 71, 200, False),
    "L1": (1, 1, 64, 64, True),
    "L5-D64": (3, 5, 64, 64, True),
    "long-narrow": (1, 5000, 16, 16, True),
    "row-stride-not-multiple-of-4": (2, 40, 64, 66, True),
}


def _cover(g, batch, length, d):
    """How many (strip, channel-block, sequence, thread) owners each
    (b, l, c) of the output has, as the kernel maps its grid."""
    count = torch.zeros((batch, length, d), dtype=torch.int32)
    rows = conv1d_kernel.ROWS
    for s in range(g.n_strips):
        l0, l1 = s * rows, min((s + 1) * rows, length)
        for cb in range(g.n_cblocks):
            for t in range(g.threads):
                c = (cb * g.threads + t) * g.vec
                if c < d:  # a thread past the edge returns at once
                    count[:, l0:l1, c:c + g.vec] += 1
    return count


def _check_covers_every_output_once(name, dtype):
    b, length, d, row, aligned = SHAPES[name]
    g = conv1d_kernel.launch_geometry(b, length, d, row, aligned=aligned, dtype=dtype)
    assert g.batch == b
    assert g.threads % 32 == 0 and 32 <= g.threads <= conv1d_kernel.MAX_THREADS
    assert g.n_blocks == g.n_strips * g.n_cblocks * b
    assert bool((_cover(g, b, length, d) == 1).all())
    # no block is empty: the last strip and the last channel block start
    # inside the tensor
    assert (g.n_strips - 1) * conv1d_kernel.ROWS < length
    assert (g.n_cblocks - 1) * g.threads * g.vec < d


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_conv1d_geometry_covers_every_output_once(name):
    _check_covers_every_output_once(name, torch.float32)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_conv1d_bf16_geometry_covers_every_output_once(name):
    _check_covers_every_output_once(name, torch.bfloat16)


@pytest.mark.parametrize("name,vec", [
    ("mamba2-wave1", 4), ("mamba2-wave2", 4), ("D73", 1), ("slice-at-offset-65", 1),
    ("row-stride-not-multiple-of-4", 1), ("L5-D64", 4),
])
def test_conv1d_geometry_vector_width(name, vec):
    """float4 units only where D, the row stride and every pointer allow
    16-byte accesses."""
    b, length, d, row, aligned = SHAPES[name]
    assert conv1d_kernel.launch_geometry(b, length, d, row, aligned=aligned).vec == vec


@pytest.mark.parametrize("name,vec", [
    ("mamba2-wave1", 8), ("mamba2-wave2", 8), ("D73", 1), ("slice-at-offset-65", 1),
    ("row-stride-not-multiple-of-4", 1), ("L5-D64", 8),
])
def test_conv1d_bf16_geometry_vector_width(name, vec):
    """At bf16 a unit is 8 values (16 bytes), where D, the row stride and
    every pointer allow it."""
    b, length, d, row, aligned = SHAPES[name]
    g = conv1d_kernel.launch_geometry(b, length, d, row, aligned=aligned, dtype=torch.bfloat16)
    assert g.vec == vec


def test_conv1d_slice_at_offset_65_is_not_aligned():
    """The alignment the wrapper passes for such a slice: its base pointer
    is 65 floats past a 16-byte boundary."""
    wide = torch.zeros((2, 50, 200), dtype=torch.float32)
    assert wide.data_ptr() % 16 == 0 and wide[..., 65:136].data_ptr() % 16 != 0


@pytest.mark.parametrize("name", ["mamba2-wave1", "mamba2-wave2"])
def test_conv1d_served_waves_fill_the_card(name):
    """Both served prefill waves launch at least two blocks per SM of the
    H100's 132: 1088 float4 units of xBC in 9 blocks of 128 threads,
    strips of 8 rows."""
    b, length, d, row, aligned = SHAPES[name]
    g = conv1d_kernel.launch_geometry(b, length, d, row, aligned=aligned)
    assert g.n_blocks >= 2 * 132
    assert (g.vec, g.threads, g.n_cblocks) == (4, 128, 9)
    assert g.n_blocks == {"mamba2-wave1": 4 * 96 * 9, "mamba2-wave2": 2 * 17 * 9}[name]


def test_conv1d_geometry_is_memoised():
    conv1d_kernel.launch_geometry(4, 768, D_XBC, WIDTH)
    hits = conv1d_kernel.launch_geometry.cache_info().hits
    g1 = conv1d_kernel.launch_geometry(4, 768, D_XBC, WIDTH)
    g2 = conv1d_kernel.launch_geometry(4, 768, D_XBC, WIDTH)
    assert g1 is g2
    assert conv1d_kernel.launch_geometry.cache_info().hits == hits + 2


def test_conv1d_geometry_takes_no_lb():
    """The reference's L block reaches neither the geometry nor the
    launch: `lb` changes nothing on the card."""
    for fn in (conv1d_kernel.launch_geometry, conv1d_kernel.conv1d_fused_call):
        assert "lb" not in inspect.signature(fn).parameters


def test_conv1d_launch_args_mirror_the_geometry():
    g = conv1d_kernel.launch_geometry(4, 768, D_XBC, WIDTH)
    a = g.launch_args(768, D_XBC, WIDTH, 4, True)
    assert (a.x_row_stride, a.batch, a.seq, a.d, a.k, a.silu) == (WIDTH, 4, 768, D_XBC, 4, 1)
    assert (a.vec, a.threads, a.n_cblocks, a.n_strips) == (
        g.vec, g.threads, g.n_cblocks, g.n_strips)
    assert [name for name, _ in conv1d_kernel.LaunchArgs._fields_] == [
        "x_row_stride", "batch", "seq", "d", "k", "silu", "vec", "threads", "n_cblocks",
        "n_strips"]


def test_conv1d_geometry_refuses_an_impossible_shape():
    with pytest.raises(ValueError, match="no geometry"):
        conv1d_kernel.launch_geometry(2, 10, 64, 32)  # rows closer than D


@pytest.mark.parametrize("k", [9, 16])
@pytest.mark.parametrize("name", ["mamba2-wave1", "D73", "L5-D64", "slice-at-offset-65"])
def test_conv1d_geometry_at_more_taps_than_a_strip(name, k):
    """K 9 and 16 run the any-K instance with the same geometry: the
    arguments `_launch_args` memoises carry K, pass the source's own checks
    (no cap on K), and cover every output once; each output's K-1 halo
    rows reach back over one or two strips before its own."""
    b, length, d, row, aligned = SHAPES[name]
    args, addr = conv1d_kernel._launch_args(b, length, d, row, k, True, aligned)
    g = conv1d_kernel.launch_geometry(b, length, d, row, aligned=aligned)
    assert addr and args.k == k and args.silu == 1
    assert (args.vec, args.threads, args.n_cblocks, args.n_strips) == (
        g.vec, g.threads, g.n_cblocks, g.n_strips)
    # the source's acceptance rules (`conv1d_fused_launch`), in order
    span = args.threads * args.vec
    assert args.k >= 1 and args.x_row_stride >= args.d
    assert args.n_strips == -(-args.seq // conv1d_kernel.ROWS)
    assert args.n_cblocks * span >= args.d > (args.n_cblocks - 1) * span
    assert bool((_cover(g, b, length, d) == 1).all())
    rows = conv1d_kernel.ROWS
    assert -(-(k - 1) // rows) == (1 if k == 9 else 2)  # strips the halo spans


@pytest.mark.parametrize("k", [1, 8, 9, 16, 64])
def test_conv1d_wrapper_takes_any_tap_count(k):
    """The refusal of K > 8 is gone: the wrapper's memoised launch
    arguments take any K >= 1 and carry it to the source unchanged."""
    assert not hasattr(conv1d_kernel, "MAX_TAPS")
    args, _ = conv1d_kernel._launch_args(2, 40, 64, 64, k, False, True)
    assert (args.k, args.silu, args.seq, args.d) == (k, 0, 40, 64)


# ------------------------------------------------------------- backward

SOURCE = conv1d_kernel.SOURCE.read_text()


def test_conv1d_backward_constants_mirror_the_source():
    assert f"constexpr int kSegRows = {conv1d_backward.SEG_ROWS};" in SOURCE
    assert f"constexpr int kMaxAnyKBwd = {conv1d_backward.MAX_TAPS};" in SOURCE


@pytest.mark.parametrize("k", [1, 4, 9])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_conv1d_backward_segments_cover_every_row_once(name, k):
    """The backward's launch arguments: the forward's channel geometry,
    `n_strips` = segments of SEG_ROWS rows that cover every row once
    (the last one starts inside the sequence), and the source's own
    acceptance rules (`conv1d_fused_bwd_launch`); the scratch holds one
    row of K + 1 partial sums per (sequence, segment)."""
    b, length, d, row, aligned = SHAPES[name]
    args, addr = conv1d_backward._launch_args(b, length, d, row, k, True, aligned)
    g = conv1d_kernel.launch_geometry(b, length, d, row, aligned=aligned)
    assert addr and (args.vec, args.threads, args.n_cblocks) == (g.vec, g.threads, g.n_cblocks)
    assert (args.k, args.silu, args.seq, args.d, args.batch) == (k, 1, length, d, b)
    seg = conv1d_backward.SEG_ROWS
    owners = torch.zeros(length, dtype=torch.int32)
    for s in range(args.n_strips):
        owners[s * seg:min((s + 1) * seg, length)] += 1
    assert bool((owners == 1).all()) and (args.n_strips - 1) * seg < length
    span = args.threads * args.vec
    assert 1 <= args.k <= conv1d_backward.MAX_TAPS and args.x_row_stride >= args.d
    assert args.n_cblocks * span >= args.d > (args.n_cblocks - 1) * span


def test_conv1d_backward_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks run before any build or launch: a CPU tensor,
    K past the source's cap, a g of another shape."""
    x, w, b = torch.zeros(2, 40, 64), torch.zeros(4, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="on the card"):
        conv1d_backward.conv1d_fused_bwd_call(x, w, b, torch.zeros(2, 40, 64),
                                              activation="silu")
    with pytest.raises(ValueError, match="activation"):
        conv1d_backward.conv1d_fused_bwd_call(x, w, b, x, activation="relu")
