"""The bf16 conv1d backward, a TMA-fed source of its own
(`conv1d_fused_bwd_bf16.cu`), on the CPU.

The kernel runs only on the card (`tests/test_torch_kernel_cuda.py`,
`chip_smoke.py`); what its wrapper computes before a launch is held
here: the geometry covers every row and channel exactly once, shared
memory fits, the partial scratch has the size the source expects; the
fp32 conv1d source holds no bf16 backward entry, and every entry point's
ctypes argument types and launch-args struct match its C declaration.
"""

import ctypes
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d_fused import backward as conv_bwd
from repro_torch.kernels.conv1d_fused import kernel as conv_kernel
from repro_torch.kernels.conv1d_fused.ref import conv1d_bwd_ref
from repro_torch.kernels.decode_mlp import kernel as mlp_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel

HEADER = flash_kernel.SOURCE.parent / "hopper.cuh"
STREAM = conv_kernel.SOURCE.parent / "stream.cuh"  # the bf16 streams' shared part
OPT_IN = _build.INCLUDE_DIR / "smem_opt_in.cuh"  # every source's shared-memory opt-in

# (B, L, D): mamba2-1.3b's and zamba2-7b's training slices, ragged shapes
CONV = {"mamba2-train": (4, 1024, 4352), "zamba2-train": (4, 1024, 7296),
        "ragged-L777": (2, 777, 104), "L5": (3, 5, 64), "L1": (1, 1, 8),
        "B1-L1000-D512": (1, 1000, 512)}


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv1d_bwd_bf16_covers_every_row_and_channel_once(name):
    """Every (sequence, row) of every channel slab in exactly one block's
    segment range, walked in chunks (a segment is two); the slabs cover
    every channel once; one wave of blocks at `BLOCKS_PER_SM` an SM."""
    b, length, d = CONV[name]
    g = conv_bwd.bf16_geometry(b, length, d)
    assert g.n_slabs * conv_bwd.SLAB >= d > (g.n_slabs - 1) * conv_bwd.SLAB
    assert g.segs == -(-length // conv_bwd.SEG_ROWS) and conv_bwd.SEG_ROWS == 2 * conv_bwd.CHUNK
    assert g.n_blocks <= conv_bwd.BLOCKS_PER_SM * conv_bwd.SM_COUNT
    rows = torch.zeros((b, length), dtype=torch.int32)
    chunks = -(-length // conv_bwd.CHUNK)
    for blk in range(g.per_slab):
        q0, q1 = g.seg_range(blk)
        assert q1 > q0  # no block without work
        for q in range(q0, q1):
            seq, s = divmod(q, g.segs)
            for j in range(2 * s, min(2 * s + 2, chunks)):
                rows[seq, j * conv_bwd.CHUNK:(j + 1) * conv_bwd.CHUNK] += 1
    assert bool((rows == 1).all())


def test_conv1d_bwd_bf16_served_geometry():
    """mamba2-1.3b training: 17 slabs x 23 blocks (391 of 396 slots), 5-6
    segments (160-192 rows) a block; a partial row set a block, 23 in
    place of the segment-walk kernel's 128 (one a 32-row segment): 2.0 MB
    of f32 partials in place of 11.1 MB."""
    g = conv_bwd.bf16_geometry(4, 1024, 4352)
    assert (g.n_slabs, g.per_slab, g.segs, g.stages) == (17, 23, 32, 2)
    spans = {q1 - q0 for q0, q1 in map(g.seg_range, range(g.per_slab))}
    assert spans == {5, 6}
    assert g.part_floats(4, 4352) == 23 * 5 * 4352
    assert 4 * conv_bwd.n_segments(1024) == 128


@pytest.mark.parametrize("k", [1, 4, 8])
def test_conv1d_bwd_bf16_scratch_and_smem(k):
    """The partial scratch is K + 1 rows of D a block of a slab, and 3
    blocks' shared memory fit an SM."""
    g = conv_bwd.bf16_geometry(4, 1024, 7296)
    assert g.per_slab == 3 * 132 // 29
    assert g.part_floats(k, 7296) == g.per_slab * (k + 1) * 7296
    assert g.smem == conv_bwd.stream_smem_bytes(g.stages)
    assert conv_bwd.BLOCKS_PER_SM * (g.smem + 1024) <= 228 * 1024
    _, args, addr = conv_bwd._bf16_launch_args(4, 1024, 7296, 14576, k, True, True)
    assert addr and (args.n_slabs, args.per_slab, args.segs, args.smem) == (
        g.n_slabs, g.per_slab, g.segs, g.smem)


def test_conv1d_bwd_bf16_any_k_takes_the_fp32_geometry():
    """K > 8 runs the segment-walk kernel kept in the bf16 source: 4 channels a
    thread in 32-row segments, no streamed fields."""
    _, args, _ = conv_bwd._bf16_launch_args(2, 300, 256, 256, 9, True, True)
    g = conv_kernel.launch_geometry(2, 300, 256, 256, True)
    assert (args.vec, args.threads, args.n_cblocks, args.n_strips) == (
        g.vec, g.threads, g.n_cblocks, conv_bwd.n_segments(300))
    assert args.n_slabs == args.per_slab == 0


def test_conv1d_bwd_bf16_pads_what_tma_cannot_address():
    """A slice at an odd column (its base and rows off 16 bytes) is copied
    into zero-padded operands whose width is a multiple of 8; the padded
    channels' gradients are zero, and the real ones are the slice's."""
    gen = torch.Generator().manual_seed(0)
    wide = torch.randn(2, 40, 300, generator=gen).bfloat16()
    x = wide[..., 65:165]
    w = torch.randn(4, 100, generator=gen).bfloat16()
    b = torch.randn(100, generator=gen).bfloat16()
    g = torch.randn(2, 40, 100, generator=gen).bfloat16()
    xp, wp, bp, gp, d = conv_bwd._tma_operands(x, w, b, g)
    assert d == 100 and xp.shape == (2, 40, 104) and wp.shape == (4, 104)
    assert xp.stride(1) % 8 == 0 and not any(t.data_ptr() % 16 for t in (xp, wp, bp, gp))
    assert torch.equal(xp[..., :100], x) and not xp[..., 100:].any()
    dx, dw, db = conv1d_bwd_ref(gp, xp, wp, bp)
    want = conv1d_bwd_ref(g, x, w, b)
    assert not dw[:, 100:].any() and not db[100:].any()
    for a, r in zip((dx[..., :100], dw[:, :100], db[:100]), want):
        assert torch.equal(a, r)
    aligned = torch.zeros(2, 40, 64, dtype=torch.bfloat16)
    w64, b64 = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16)
    assert conv_bwd._tma_operands(aligned, w64, b64, aligned)[0] is aligned


def test_fp32_sources_hold_no_bf16_entry():
    """The conv1d source lost its bf16 backward (it keeps the fp32
    forward and backward and the bf16 forward)."""
    conv = conv_kernel.SOURCE.read_text()
    assert "conv1d_fused_bwd_bf16_launch" not in conv
    assert 'extern "C" int conv1d_fused_bwd_launch(' in conv
    assert 'extern "C" int conv1d_fused_bf16_launch(' in conv
    assert "conv1d_fused_bwd_bf16_launch" not in conv_kernel.LIB.entry_points


def _c_argtypes(source, entry: str) -> list:
    """The ctypes types of `entry`'s C parameters in `source`, in order."""
    params = re.search(rf'extern "C" int {entry}\((.*?)\)', source.read_text(), re.S).group(1)
    kinds = []
    for p in (q.strip() for q in params.split(",")):
        if "*" in p:
            kinds.append(ctypes.c_void_p)
        else:
            assert p.startswith("int "), p
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("lib,entry", [
    (mlp_kernel.LIB, mlp_kernel.ENTRY[torch.float32]),
    (mlp_kernel.LIB, mlp_kernel.ENTRY[torch.bfloat16]),
    (conv_bwd.library(torch.float32), conv_bwd.ENTRY[torch.float32]),
    (conv_bwd.library(torch.bfloat16), conv_bwd.ENTRY[torch.bfloat16]),
], ids=["mlp-fp32", "mlp-bf16", "conv-bwd-fp32", "conv-bwd-bf16"])
def test_ctypes_bindings_match_the_c_signatures(lib, entry):
    assert _c_argtypes(lib.source, entry) == list(lib.entry_points[entry])


def _c_struct_fields(source, name: str) -> list:
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", source.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            typ, names = decl.split(None, 1) if not decl.startswith("long long") else (
                "long long", decl[len("long long"):])
            fields += [(n.strip(), typ) for n in names.split(",")]
    return fields


@pytest.mark.parametrize("source,name,cls", [
    (mlp_kernel.SOURCE, "LaunchArgs", mlp_kernel.LaunchArgs),
    (conv_bwd.SOURCE_BF16, "BwdBf16Args", conv_bwd.BwdBf16Args),
], ids=["decode-mlp", "conv1d-bwd"])
def test_launch_args_structs_mirror_the_sources(source, name, cls):
    want = [(n, ctypes.c_longlong if t == "long long" else ctypes.c_int)
            for n, t in _c_struct_fields(source, name)]
    assert [(n, t) for n, t in cls._fields_] == want


def test_bf16_sources_stream_by_tma_without_float_atomics():
    """The source copies by TMA on mbarriers (`hopper.cuh`'s stream
    section, through the streams' shared `stream.cuh`), hashes both headers
    with it, and sums without atomics."""
    src = conv_bwd.SOURCE_BF16
    text = src.read_text()
    assert '#include "stream.cuh"' in text
    assert '#include "../../flash_attention/csrc/hopper.cuh"' in STREAM.read_text()
    assert "hopper::mbar_wait(" in text and "hopper::mbar_expect(" in text
    assert "hopper::tma_load3(" in text and "hopper::tma_store3(" in text
    assert "cp.async.cg" not in text and "__ldg(" not in text.split("K > 8")[0]
    assert not re.search(r"\batomic[A-Z]\w*\(|\bred\.|\batom\.", text)
    assert _build.source_text(src) == (src.read_bytes() + STREAM.read_bytes()
                                       + HEADER.read_bytes() + OPT_IN.read_bytes())
    header = HEADER.read_text()
    for fn in ("tma_load3", "tma_store3", "encode_plain"):
        assert re.search(rf"\b{fn}\(", header)


def test_wrappers_pick_each_element_types_library():
    assert conv_bwd.library(torch.float32) is conv_kernel.LIB
    assert conv_bwd.library(torch.bfloat16) is conv_bwd.LIB_BF16
    assert conv_bwd.LIB_BF16.source.name == "conv1d_fused_bwd_bf16.cu"


def test_conv1d_bwd_bf16_constants_mirror_the_source():
    text = _build.source_text(conv_bwd.SOURCE_BF16).decode()  # with `stream.cuh`
    for line in (f"constexpr int kMaxTaps = {conv_bwd.STREAM_TAPS};",
                 f"constexpr int kSlab = {conv_bwd.SLAB};",
                 f"constexpr int kChunk = {conv_bwd.CHUNK};",
                 f"constexpr int kHaloRows = {conv_bwd.HALO_ROWS};",
                 f"constexpr int kDxBuffers = {conv_bwd.DX_BUFFERS};",
                 f"constexpr int kSegRows = {conv_bwd.SEG_ROWS};     // rows of a segment",
                 f"constexpr int kMaxAnyKBwd = {conv_bwd.MAX_TAPS};",
                 f"__launch_bounds__(kThreads, {conv_bwd.BLOCKS_PER_SM})"):
        assert line in text, line
    max_stages = int(re.search(r"constexpr int kMaxStages = (\d+);", text).group(1))
    assert 2 <= conv_bwd.STAGES <= max_stages


def test_bf16_wrappers_refuse_cpu_tensors_before_any_launch():
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    w1 = torch.zeros(64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on the card"):
        mlp_kernel.decode_mlp_call(x, w1, w1, torch.zeros(96, 64, dtype=torch.bfloat16))
    xc = torch.zeros(2, 40, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on the card"):
        conv_bwd.conv1d_fused_bwd_call(xc, torch.zeros(4, 64, dtype=torch.bfloat16),
                                       torch.zeros(64, dtype=torch.bfloat16), xc,
                                       activation="silu")


def test_conv1d_bwd_bf16_reduces_a_partial_set_a_block():
    """The streamed kernel writes one partial row set a block, after its
    whole range, and its reduction adds `per_slab` sets, the scratch the
    wrapper sizes; the segment-walk kernel (K > 8) keeps a set a segment."""
    text = conv_bwd.SOURCE_BF16.read_text()
    assert "if (active) write_partial(part + ((size_t)kb * (K + 1)) * a.d + c);" in text
    assert "return launch_reduce(part, dw, db, a.per_slab, a, s);" in text
    assert "return launch_reduce(part, dw, db, a.batch * a.n_strips, a, s);" in text
    g = conv_bwd.bf16_geometry(2, 300, 512)
    assert g.part_floats(3, 512) == g.per_slab * 4 * 512 <= 2 * g.segs * 4 * 512
