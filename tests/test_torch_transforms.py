"""The port's basis math and tiling (`repro_torch.core`) against the
reference package (`repro.core`): the same inputs, drawn with numpy,
through both.

Tolerances: basis matrices and tiles are computed by the same numpy /
gather code, so they must agree exactly; transformed kernels go through
two frameworks' einsum / FFT, so they agree to fp32 rounding (1e-6
relative to the largest entry).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiling as ref_tiling
from repro.core import transforms as ref_tr
from repro_torch.core import analysis, tiling, transforms
from repro_torch.core.sharedbuf import SharedBufferPlan
from repro_torch.kernels.fused_tile import kernel as tile_kernel

SPECS = [("winograd", m) for m in range(2, 7)] + [("fft", 8), ("fft", 16)]


def _pair(family, size):
    """(reference Transform, port Transform) for one family/tile size."""
    if family == "winograd":
        return (ref_tr.WinogradTransform(m=size, k=3),
                transforms.WinogradTransform(m=size, k=3))
    return ref_tr.FFTTransform(t=size, k=3), transforms.FFTTransform(t=size, k=3)


@pytest.mark.parametrize("family,size", SPECS)
def test_tile_kernel_spec_equals_reference(family, size):
    ref, port = _pair(family, size)
    rs, ps = ref.kernel_spec(), port.kernel_spec()
    for f in ("family", "t", "t_out", "k", "planes", "s_mix"):
        assert getattr(rs, f) == getattr(ps, f), f
    np.testing.assert_array_equal(rs.fwd, ps.fwd)
    np.testing.assert_array_equal(rs.inv, ps.inv)
    assert dataclasses.asdict(ref.algebra) == dataclasses.asdict(port.algebra)
    assert rs.macs_per_tile(8, 16, 2) == ps.macs_per_tile(8, 16, 2)


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("family,size", [("winograd", 3), ("fft", 8)])
def test_kernel_transform_and_pack_rhs_match(family, size, groups):
    ref, port = _pair(family, size)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 3, 6 // groups, 4)) * 0.1).astype(np.float32)
    wt_ref = np.asarray(ref.kernel_transform(jnp.asarray(w)))
    wt_port = port.kernel_transform(torch.from_numpy(w)).numpy()
    scale = np.abs(wt_ref).max()
    assert np.abs(wt_port - wt_ref).max() <= 1e-6 * scale
    rhs_ref = np.asarray(ref.kernel_spec().pack_rhs(jnp.asarray(wt_ref), groups))
    rhs_port = port.kernel_spec().pack_rhs(torch.tensor(wt_ref), groups)
    assert rhs_port.is_contiguous() and rhs_port.dtype == torch.float32
    assert np.abs(rhs_port.numpy() - rhs_ref).max() <= 1e-6 * scale


@pytest.mark.parametrize("geom", [(13, 11, 1, 5), (16, 16, 1, 7), (9, 20, 0, 16)])
def test_tiles_and_assembly_bitwise(geom):
    h, w, pad, t = geom
    plan = tiling.TilePlan.build(h, w, 3, pad, t)
    rplan = ref_tiling.TilePlan.build(h, w, 3, pad, t)
    assert dataclasses.asdict(plan) == dataclasses.asdict(rplan)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    xp = tiling.pad_input(torch.from_numpy(x), plan)
    rxp = ref_tiling.pad_input(jnp.asarray(x), rplan)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(rxp))
    tiles = tiling.extract_tiles(xp, plan)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(ref_tiling.extract_tiles(rxp, rplan))
    )
    y = rng.standard_normal(
        (2, plan.n_tiles_h, plan.n_tiles_w, plan.t_out, plan.t_out, 5)
    ).astype(np.float32)
    np.testing.assert_array_equal(
        tiling.assemble_tiles(torch.from_numpy(y), plan).numpy(),
        np.asarray(ref_tiling.assemble_tiles(jnp.asarray(y), rplan)),
    )


def test_h100_model_sizes_r_to_the_kernel_buffer():
    """`H100_SXM` is the card's data sheet: the planner's R bound keeps
    the tile kernel's aliased buffer within half a block's shared
    memory, and CMR_fast 4 puts the R lower bound at 8."""
    hw = analysis.H100_SXM
    assert hw.private_bytes == tile_kernel.MAX_SMEM_BYTES == 232_448
    assert hw.fast_shared_bytes == 50 * 2**20
    assert hw.cmr_fast == pytest.approx(4.0)
    assert analysis.min_r(hw) == 8
    for tr in (transforms.WinogradTransform(m=5, k=3),
               transforms.FFTTransform(t=16, k=3)):
        spec = tr.kernel_spec()
        for c_in, c_out in ((3, 64), (64, 64), (8, 8), (4, 8)):
            r = analysis.max_r_ta(hw, c_in, c_out, tr.algebra)
            assert tile_kernel.buffer_bytes(spec, r, c_in, c_out) <= hw.private_bytes // 2
            # the kernel buffer is exactly the sharedbuf accounting
            ta = tr.algebra
            assert tile_kernel.buffer_bytes(spec, r, c_in, c_out) == SharedBufferPlan(
                r=r, c_in=c_in, c_out=c_out, t2=ta.domain_points,
                elem_bytes=ta.elem_bytes,
            ).bytes
