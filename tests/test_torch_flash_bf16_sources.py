"""The bf16 flash kernels' sources and build keys, on the CPU.

The bf16 forward and backward are sources of their own on warpgroup
`wgmma` (`flash_attention_bf16.cu`, `flash_attention_bwd_bf16.cu`), built
from `hopper.cuh`'s blocks: every product `wgmma.mma_async`, no bf16
`mma.sync` left; `hopper.cuh` specialises `Mma<N>` at every n-width the
two kernels instantiate for `HEAD_DIMS`; the fp32 sources keep no bf16
instantiation; a header's edit changes the library's build key; and the
wrappers pick each element type's library.  The kernels themselves run
only on the card (`tests/test_torch_kernel_cuda.py`).
"""

import ctypes
import pathlib
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import backward as bk
from repro_torch.kernels.flash_attention import bf16_choices, bf16_clocks
from repro_torch.kernels.flash_attention import kernel as fk

CSRC = fk.SOURCE.parent
HEADER = CSRC / "hopper.cuh"
OPT_IN = _build.INCLUDE_DIR / "smem_opt_in.cuh"  # every source's shared-memory opt-in
BF16_SOURCES = {"forward": fk.SOURCE_BF16, "backward": bk.SOURCE_BF16}


@pytest.mark.parametrize("which", sorted(BF16_SOURCES))
def test_bf16_sources_run_their_products_on_wgmma(which):
    text = BF16_SOURCES[which].read_text()
    assert '#include "hopper.cuh"' in text
    assert "mma.sync" not in text and "ldmatrix" not in text
    assert re.search(r"Mma<[^>]+>::(template )?(ss|rs)<", text)
    # the backward's sums are deterministic: no atomic instruction
    assert not re.search(r"\batomic[A-Z]\w*\(|\bred\.|\batom\.", text)
    header = HEADER.read_text()
    assert "wgmma.mma_async.sync.aligned" in header and "mma.sync" not in header


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_fp32_sources_hold_no_bf16_instantiation(which):
    src = {"forward": fk.SOURCE, "backward": bk.SOURCE}[which]
    text = src.read_text()
    assert "m16n8k16" not in text and "__nv_bfloat16" not in text
    assert "bf16_launch(" not in text


def _specialised() -> set:
    return {int(n) for n in re.findall(r"struct Mma<(\d+)> \{", HEADER.read_text())}


def _widths(hd: int, vd: int) -> set:
    """The n-widths the two kernels instantiate at (hd, vd): the 64-key /
    64-row score tiles, P.V's and dV's vd, dK's hd, and dQ's split between
    the two warpgroups (whole 64-column atoms, half of them rounded up, to
    the first)."""
    atoms = -(-hd // 64)
    nq0 = hd if hd <= 64 else 64 * ((atoms + 1) // 2)
    return {64, vd, hd, nq0} | ({hd - nq0} if hd > nq0 else set())


@pytest.mark.parametrize("hd,vd", fk.HEAD_DIMS)
def test_header_specialises_every_width_the_kernels_take(hd, vd):
    have = _specialised()
    assert _widths(hd, vd) <= have
    assert all(n % 8 == 0 and 8 <= n <= 256 for n in have)  # wgmma's bf16 n-widths


def test_header_has_no_width_the_kernels_do_not_take():
    need = set().union(*(_widths(hd, vd) for hd, vd in fk.HEAD_DIMS))
    assert _specialised() == need


def test_every_source_instantiates_every_head_dim_pair():
    for src in (fk.SOURCE, fk.SOURCE_BF16, bk.SOURCE, bk.SOURCE_BF16):
        cases = set(re.findall(r"FLASH(?:_BWD)?_CASE\((\d+), (\d+)\)\n", src.read_text()))
        assert cases == {(str(hd), str(vd)) for hd, vd in fk.HEAD_DIMS}, src.name


def test_build_key_covers_the_included_header(tmp_path, monkeypatch):
    """`CudaLibrary.library_path` hashes a source with the headers it
    includes: editing the header alone names another library."""
    header = tmp_path / "blocks.cuh"
    header.write_text("#pragma once\n#define WIDTH 64\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "blocks.cuh"\n#include <cuda_runtime.h>\nint x = WIDTH;\n')
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.CudaLibrary(src, "k", {})
    before = lib.library_path()
    assert _build.source_text(src) == src.read_bytes() + header.read_bytes()
    header.write_text("#pragma once\n#define WIDTH 128\n")
    assert lib.library_path() != before
    src_only = tmp_path / "plain.cu"
    src_only.write_text("int y;\n")
    assert _build.source_text(src_only) == src_only.read_bytes()


def test_the_committed_bf16_sources_hash_their_header():
    for src in BF16_SOURCES.values():
        assert _build.source_text(src) == (src.read_bytes() + HEADER.read_bytes()
                                           + OPT_IN.read_bytes())
    assert _build.source_text(fk.SOURCE) == fk.SOURCE.read_bytes() + OPT_IN.read_bytes()


@pytest.mark.parametrize("mod", [fk, bk], ids=["forward", "backward"])
def test_wrappers_pick_each_element_types_library(mod):
    assert mod.library(torch.float32) is mod.LIB
    assert mod.library(torch.bfloat16) is mod.LIB_BF16
    assert mod.LIB.source == mod.SOURCE and mod.LIB_BF16.source == mod.SOURCE_BF16
    assert set(mod.LIB.entry_points) == {mod.ENTRY[torch.float32]}
    assert set(mod.LIB_BF16.entry_points) == {mod.ENTRY[torch.bfloat16]}
    assert pathlib.Path(mod.SOURCE_BF16).exists()


def _c_argtypes(source: pathlib.Path, entry: str) -> list:
    """The ctypes types of `entry`'s C parameters in `source`, in order."""
    params = re.search(rf'extern "C" int {entry}\((.*?)\)', source.read_text(), re.S).group(1)
    kinds = []
    for p in (q.strip() for q in params.split(",")):
        if "*" in p:
            kinds.append(ctypes.c_void_p)
        elif p.startswith("long long "):
            kinds.append(ctypes.c_longlong)
        elif p.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            assert p.startswith("int "), p
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("mod", [fk, bk], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ctypes_bindings_match_the_c_signatures(mod, dtype):
    """Each entry point's bound argument types are its C parameters' (the
    bf16 forward's take the block order after the window)."""
    lib = mod.library(dtype)
    entry = mod.ENTRY[dtype]
    assert _c_argtypes(lib.source, entry) == list(lib.entry_points[entry])


def test_block_order_is_one_rule_for_both_kernels():
    """Both bf16 kernels order their blocks a (batch, kv head) at a time
    where K and V outgrow the L2, and `bf16_choices.block_order` forces
    either order in both wrappers and puts the rule back."""
    assert bk.head_major is fk.head_major
    moonshot = (4, 16, 16, 1024, 1024, 128, True, 0, 128, torch.bfloat16)
    assert not fk.head_major(4, 16, 1024, 128, 128, torch.bfloat16)
    assert fk.head_major(4, 128, 1024, 192, 128, torch.bfloat16)
    assert not fk.head_major(4, 128, 1024, 192, 128, torch.float32)
    free = bk.work_list(*moonshot)
    rule = fk.head_major
    with bf16_choices.block_order(True):
        assert fk.head_major(1, 1, 1, 16, 16, torch.float32) and bk.head_major is fk.head_major
        grouped = bk.work_list(*moonshot)
        assert grouped != free and sorted(grouped) == sorted(free)
        heads = [it[1] for it in grouped]  # MHA: an item's head is its kv head
        assert heads == sorted(heads)
    assert fk.head_major is rule and bk.head_major is rule
    assert bk.work_list(*moonshot) == free


def test_bf16_clocks_instruments_the_committed_sources():
    """`bf16_clocks` finds its anchors in both committed sources: one mark a
    part of each loop and one flush a loop; the committed sources carry
    none."""
    fwd = bf16_clocks.instrument_forward(fk.SOURCE_BF16.read_text())
    bwd = bf16_clocks.instrument_backward(bk.SOURCE_BF16.read_text())
    uses = lambda text: len(re.findall(r"MARK\(\d\)", text))
    loops = bf16_clocks.LOOPS
    assert uses(fwd) == len(loops["forward"][1])
    assert uses(bwd) == sum(len(parts) for name, (_, parts) in loops.items() if name != "forward")
    assert fwd.count("MARK_FLUSH(") == 2 and bwd.count("MARK_FLUSH(") == 5  # the macro, each loop
    for src in BF16_SOURCES.values():
        assert "MARK" not in src.read_text() and "clock64" not in src.read_text()


def test_checked_signatures_are_bounded(monkeypatch):
    """The wrappers check an argument signature once; the set of checked
    signatures empties when full, so a process that sees ever new shapes
    does not grow it without end."""
    monkeypatch.setattr(fk, "CHECKED", set())
    monkeypatch.setattr(fk, "CHECKED_MAX", 3)
    q = torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16)
    assert fk.signature(q) == ((q.shape, q.stride(), q.dtype, -1),)
    assert fk.signature(q) != fk.signature(q.transpose(1, 2))
    for n in range(1, 4):
        fk.checked(fk.signature(q[..., :8 * n]))
    assert len(fk.CHECKED) == 3
    fk.checked(fk.signature(q))
    assert fk.CHECKED == {fk.signature(q)}


def test_output_strides_follow_the_input_layout():
    """`empty_in_layout` allocates the output dense in q's memory order:
    (B, S, H, vd) memory under a (B, H, S, vd) view of the model's
    (B, S, H, hd) activations, (B, H, S, vd) for contiguous q."""
    model = torch.zeros(2, 7, 3, 64).transpose(1, 2)  # (B, H, S, hd) view of (B, S, H, hd)
    out = fk.empty_in_layout(model, 32)
    assert out.shape == (2, 3, 7, 32) and out.stride() == (7 * 3 * 32, 32, 3 * 32, 1)
    dense = fk.empty_in_layout(torch.zeros(2, 3, 7, 64), 16)
    assert dense.stride() == (3 * 7 * 16, 7 * 16, 16, 1)
