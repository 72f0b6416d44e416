"""The decode-MLP wrapper's launch geometry, on the CPU.

The kernel runs only on the card (`tests/test_torch_kernel_cuda.py`,
`chip_smoke.py`); what its wrapper computes before a launch, once per
shape, is checked here: one block per SM, an even share of d_ff's
columns cut on grains, threads, slots, the deepest ring that fits, and
the shared memory it passes to the kernel.
"""

import pytest
import torch

from repro_torch.kernels.decode_mlp import kernel as mlp_kernel

SHAPES = {
    # name: (B, d, f)
    "gemma3-served-B4": (4, 1152, 6912),
    "gemma3-B2": (2, 1152, 6912),
    "gemma3-B1": (1, 1152, 6912),
    "ragged-B11": (11, 200, 700),
    "f-not-multiple-of-4": (1, 64, 33),
    "B3": (3, 96, 300),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_decode_mlp_geometry_covers_the_work(name):
    b, d, f = SHAPES[name]
    g = mlp_kernel.launch_geometry(b, d, f)
    assert g.vec == (4 if d % 4 == 0 and f % 4 == 0 else 1)
    gran = 2 if g.vec == 4 else 1  # 32 bytes of a weight row for float4 units
    grains = -(-(f // g.vec) // gran)
    assert g.n_blocks == min(mlp_kernel.SM_COUNT, grains)
    assert g.uf % gran == 0 and g.uf // gran * g.n_blocks >= grains  # d_ff is covered
    assert g.uf // gran == -(-grains // g.n_blocks)  # the largest of even shares
    assert g.threads % 32 == 0 and g.threads <= mlp_kernel.MAX_THREADS
    t3 = g.slots2 * g.dut
    assert g.threads == mlp_kernel.MAX_THREADS or g.threads >= mlp_kernel.MIN_THREADS
    assert 1 <= g.slots1 and g.slots1 * g.uf <= g.threads
    assert 1 <= g.slots2 and t3 <= g.threads and g.dut <= d // g.vec
    assert g.rb == min(b, mlp_kernel.MAX_ROWS)
    assert g.smem == mlp_kernel.smem_bytes(d, g.rb, g.vec, g.threads, g.uf, g.slots1,
                                           g.slots2, g.depth)
    assert g.smem <= mlp_kernel.MAX_SMEM_BYTES
    deeper = [k for k in mlp_kernel.DEPTHS if k > g.depth]  # the deepest ring that fits
    assert all(mlp_kernel.smem_bytes(d, g.rb, g.vec, g.threads, g.uf, g.slots1, g.slots2, k)
               > mlp_kernel.MAX_SMEM_BYTES for k in deeper)


def test_decode_mlp_served_geometry_is_one_even_wave():
    """gemma3-1b decode: 132 blocks of 12-14 float4 columns (6-7 32-byte
    sectors of each weight row), one per SM."""
    g = mlp_kernel.launch_geometry(4, 1152, 6912)
    assert (g.vec, g.n_blocks, g.uf, g.threads, g.slots1, g.slots2, g.dut) == (
        4, 132, 14, 576, 41, 1, 288)
    # x^T, the 41 slots' sums of W1 and W3, h, then the rings: 6 rows of W1
    # and W3 in flight per thread
    assert g.depth == 6 and g.smem == 4 * (1152 * 4 + 2 * 41 * 4 * 56 + 4 * 56 + 2 * 6 * 576 * 4)
    assert mlp_kernel.launch_geometry(4, 1152, 6912, aligned=False).vec == 1


def test_decode_mlp_geometry_takes_a_shallower_ring_when_the_deep_one_does_not_fit():
    g = mlp_kernel.launch_geometry(4, 4096, 16384)
    assert g.depth == 2 and g.smem <= mlp_kernel.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        mlp_kernel.launch_geometry(4, 32768, 4096)


def test_decode_mlp_launch_args_mirror_the_geometry():
    g = mlp_kernel.launch_geometry(4, 1152, 6912)
    a = g.launch_args(4, 1152, 6912)
    assert (a.batch, a.d, a.f, a.n_blocks, a.threads, a.depth, a.smem) == (
        4, 1152, 6912, g.n_blocks, g.threads, g.depth, g.smem)
    assert [name for name, _ in mlp_kernel.LaunchArgs._fields_][3:] == [
        "vec", "rb", "n_blocks", "threads", "uf", "slots1", "slots2", "dut", "depth",
        "smem"]


def test_decode_mlp_geometry_is_memoised():
    mlp_kernel.launch_geometry(4, 1152, 6912)
    hits = mlp_kernel.launch_geometry.cache_info().hits
    g1 = mlp_kernel.launch_geometry(4, 1152, 6912)
    g2 = mlp_kernel.launch_geometry(4, 1152, 6912)
    assert g1 is g2
    assert mlp_kernel.launch_geometry.cache_info().hits == hits + 2


@pytest.mark.parametrize("b,d,f", [(4, 1152, 6912), (1, 1152, 6912), (2, 3584, 14336),
                                   (4, 3584, 14336), (1, 1024, 4096), (11, 200, 704)])
def test_decode_mlp_bf16_geometry_covers_the_work(b, d, f):
    """At bf16 a unit is 8 values (16 bytes), a grain two units, at most
    `MAX_THREADS_BF16` threads a block, and the ring holds 2-byte values."""
    g = mlp_kernel.launch_geometry(b, d, f, dtype=torch.bfloat16)
    grains = -(-(f // 8) // 2)
    assert g.vec == 8 and g.n_blocks == min(mlp_kernel.SM_COUNT, grains)
    assert g.uf % 2 == 0 and g.uf // 2 * g.n_blocks >= grains
    assert g.threads % 32 == 0 and g.threads <= mlp_kernel.MAX_THREADS_BF16
    assert 1 <= g.slots1 and g.slots1 * g.uf <= g.threads
    assert 1 <= g.slots2 and g.slots2 * g.dut <= g.threads and g.dut <= d // 8
    assert g.smem == mlp_kernel.smem_bytes(d, g.rb, 8, g.threads, g.uf, g.slots1, g.slots2,
                                           g.depth, 2)
    assert g.smem <= mlp_kernel.MAX_SMEM_BYTES


@pytest.mark.parametrize("d,f,aligned", [(1152, 6900, True), (1150, 6912, True),
                                         (1152, 6912, False)])
def test_decode_mlp_bf16_refuses_widths_off_its_units(d, f, aligned):
    with pytest.raises(ValueError, match="multiples of 8"):
        mlp_kernel.launch_geometry(4, d, f, aligned=aligned, dtype=torch.bfloat16)


def test_decode_mlp_bf16_launch_bound_is_the_sources():
    assert (f"constexpr int kMaxThreadsBf16 = {mlp_kernel.MAX_THREADS_BF16};"
            in mlp_kernel.SOURCE.read_text())
