"""The kernel sources' dynamic shared-memory opt-in, read from the
sources (no card here): `cudaFuncSetAttribute`'s
`cudaFuncAttributeMaxDynamicSharedMemorySize` holds for the current
device only, so a flag kept once per process lets the first card opt in
and leaves every other card of the process refusing the launch.  One
shared header (`kernels/csrc/smem_opt_in.cuh`) keeps the opt-in per
device (`OptIn`, indexed by `cudaGetDevice`) and is the only place that
sets the attribute; every launch that asks for dynamic shared memory
above 48 KB calls it.  On the card
`test_cuda_every_kernel_launches_on_cuda1_after_cuda0` launches each on
a second card.
"""

import pathlib
import re

import pytest

from repro_torch.kernels import _build

KERNELS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
HEADER = KERNELS / "csrc" / "smem_opt_in.cuh"
SOURCES = {
    # source: the kernel templates its launches opt in for
    "fused_tile/csrc/fused_tile.cu": ["fused_tile_kernel<P, NA, STAGE_RHS>"],
    "decode_mlp/csrc/decode_mlp.cu": ["decode_mlp_partial<T, RB, V, DEPTH>"],
    "flash_attention/csrc/flash_attention.cu": ["flash_fwd_kernel<DK, DV>"],
    "flash_attention/csrc/flash_attention_bf16.cu": ["flash_fwd_bf16_kernel<DK, DV>"],
    "flash_attention/csrc/flash_attention_bwd.cu": ["flash_bwd_kernel<DK, DV>"],
    "flash_attention/csrc/flash_attention_bwd_bf16.cu": ["flash_bwd_bf16_kernel<DK, DV>"],
    "conv1d_fused/csrc/conv1d_fused_fwd_bf16.cu": ["kernel"],
    "conv1d_fused/csrc/conv1d_fused_bwd_bf16.cu": ["kernel"],
}


def _code(text: str) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_the_shared_header_keeps_the_opt_in_per_device():
    code = _code(HEADER.read_text())
    assert code.count("cudaFuncSetAttribute(") == 1
    helper = code[code.index("int opt_in_smem("):]
    helper = helper[:helper.index("\n}\n")]
    assert "cudaFuncSetAttribute(" in helper and "cudaGetDevice(&dev)" in helper
    assert "opted.bytes[dev]" in helper and "std::lock_guard<std::mutex>" in helper
    assert "kOptInDevices = 16" in code
    assert "static" not in code


def test_every_opting_source_is_listed():
    """No kernel source sets the attribute itself, and the sources that
    call the shared helper are SOURCES (the fp32 conv1d asks for no
    dynamic shared memory above 48 KB)."""
    codes = {str(p.relative_to(KERNELS)): _code(p.read_text())
             for p in KERNELS.glob("*/csrc/*.cu*")}
    assert not [s for s, c in codes.items() if "cudaFuncAttributeMaxDynamicSharedMemorySize" in c]
    assert {s for s, c in codes.items() if "opt_in_smem(" in c} == set(SOURCES)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_the_opt_in_is_kept_per_device(source):
    path = KERNELS / source
    code = _code(path.read_text())
    assert '#include "smem_opt_in.cuh"' in code
    # the build finds the header on nvcc's -I and hashes it with the source
    assert HEADER.read_bytes() in _build.source_text(path)
    # no flag kept once per process
    assert "cudaFuncSetAttribute(" not in code
    assert not re.search(r"static\s+(bool|int)\s+opted", code)
    for kernel in SOURCES[source]:
        assert f"opt_in_smem({kernel}," in code, kernel
    assert code.count("static OptIn opted;") == len(SOURCES[source])
