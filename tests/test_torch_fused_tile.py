"""The port's tile engine (`repro_torch.kernels.fused_tile`) against the
reference engine (`repro.kernels.fused_tile`).

On the CPU the port's `conv2d_fused_tile` runs the kernel's plain
version (`matrix_tile_conv`); it is held against the reference's matrix
path (``backend="xla"``) and its Pallas kernel in interpret mode
(``backend="pallas_interpret"``) over the reference's own parity grid:
transform families x scenarios, at rel < 5e-5 (the reference's engine
tolerance).  The CUDA kernel itself runs only on the card: see
`test_torch_kernel_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as ref_registry
from repro.core import tiling as ref_tiling
from repro.core import transforms as ref_tr
from repro.kernels import fused_tile as ref_ft
from repro_torch.core import registry, tiling, transforms
from repro_torch.kernels import fused_tile as ft
from repro_torch.kernels.fused_tile import kernel as tile_kernel

FAMILIES = ("winograd", "fft")
SCENARIOS = ("plain", "stride2", "grouped", "ragged", "bias_relu", "chunked")
REF_BACKENDS = ("xla", "pallas_interpret")
TOL = 5e-5


def _pair(family):
    if family == "winograd":  # T=5
        return ref_tr.WinogradTransform(m=3, k=3), transforms.WinogradTransform(m=3, k=3)
    return ref_tr.FFTTransform(t=8, k=3), transforms.FFTTransform(t=8, k=3)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("ref_backend", REF_BACKENDS)
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_parity_with_reference(family, scenario, ref_backend):
    ref_tr_, tr = _pair(family)
    rng = np.random.default_rng(11)
    groups = 2 if scenario == "grouped" else 1
    b, h, w, c_in, c_out = 2, 14, 14, 4, 4
    if scenario == "ragged":  # extents not a tile-grid multiple
        h, w = 13, 11
    x = (rng.standard_normal((b, h, w, c_in)) * 0.1).astype(np.float32)
    wk = (rng.standard_normal((3, 3, c_in // groups, c_out)) * 0.1).astype(np.float32)
    bvec = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    blocks = ref_blocks = None
    if scenario == "chunked":  # bounded-working-set sweep (tpp > 0)
        blocks = ft.BlockConfig(r=2, tasks_per_program=2)
        ref_blocks = ref_ft.BlockConfig(r=2, tasks_per_program=2)
    ep = ref_ep = None
    if scenario == "bias_relu":
        ep = registry.ElementwiseOps((("bias", torch.from_numpy(bvec)), ("relu",)))
        ref_ep = ref_registry.ElementwiseOps((("bias", jnp.asarray(bvec)), ("relu",)))

    y = ft.conv2d_fused_tile(
        torch.from_numpy(x), torch.from_numpy(wk), tr, pad=1, blocks=blocks,
        groups=groups, epilogue=ep, device="cpu",
    )
    ref = ref_ft.conv2d_fused_tile(
        jnp.asarray(x), jnp.asarray(wk), ref_tr_, pad=1, blocks=ref_blocks,
        groups=groups, epilogue=ref_ep, backend=ref_backend,
    )
    if scenario == "stride2":  # engine is stride-1 + decimation
        y, ref = registry.decimate(y, 2), ref_registry.decimate(ref, 2)
    assert y.device.type == "cpu" and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y.numpy(), ref) < TOL, (family, scenario, ref_backend)


@pytest.mark.parametrize("family", FAMILIES)
def test_three_stage_through_same_spec(family):
    """The materializing three-stage structure consumes the same
    `TileKernelSpec` as the fused kernel and matches the reference's."""
    ref_tr_, tr = _pair(family)
    rng = np.random.default_rng(5)
    b, h, w, c_in, c_out = 2, 12, 12, 3, 5
    x = (rng.standard_normal((b, h, w, c_in)) * 0.1).astype(np.float32)
    wk = (rng.standard_normal((3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    plan = tiling.TilePlan.build(h, w, tr.k, 1, tr.t)
    s1, s2, s3 = ft.staged_matrix_fns(plan, tr.kernel_spec())
    y = s3(s2(s1(tiling.pad_input(torch.from_numpy(x), plan)),
              tr.kernel_transform(torch.from_numpy(wk))), b)
    rplan = ref_tiling.TilePlan.build(h, w, ref_tr_.k, 1, ref_tr_.t)
    r1, r2, r3 = ref_ft.staged_matrix_fns(rplan, ref_tr_.kernel_spec())
    ref = r3(r2(r1(ref_tiling.pad_input(jnp.asarray(x), rplan)),
                ref_tr_.kernel_transform(jnp.asarray(wk))), b)
    assert tuple(y.shape) == tuple(ref.shape)
    assert _rel(y.numpy(), ref) < TOL
    direct = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wk), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    assert _rel(y.numpy(), direct) < TOL


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On a CPU tensor the kernel wrapper raises (the engine routes CPU
    tensors to the plain version before it is reached); it never
    computes anything itself off the card."""
    spec = transforms.WinogradTransform(m=3, k=3).kernel_spec()
    plan = tiling.TilePlan.build(10, 10, 3, 1, spec.t)
    xp = torch.zeros((1, plan.h_pad, plan.w_pad, 2))
    rhs = torch.zeros((spec.s_mix, 1, 2, 3))
    before = tile_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tile_kernel.fused_tile_call(
            xp, rhs, torch.zeros((1, 3)), spec=spec,
            n_tiles_h=plan.n_tiles_h, n_tiles_w=plan.n_tiles_w, r=1,
        )
    assert tile_kernel.LAUNCHES == before


def test_fit_r_lowers_r_to_the_block_buffer():
    """The untuned default R=24 does not fit at 64 channels; the wrapper
    lowers it to the largest R whose (S+1, R, P*max(C, C')) buffer fits
    a block, and raises only when R=1 does not fit."""
    wino = transforms.WinogradTransform(m=5, k=3).kernel_spec()
    assert tile_kernel.buffer_bytes(wino, 24, 64, 64) > tile_kernel.MAX_SMEM_BYTES
    r = tile_kernel.fit_r(wino, 24, 64, 64)
    assert tile_kernel.buffer_bytes(wino, r, 64, 64) <= tile_kernel.MAX_SMEM_BYTES
    assert tile_kernel.buffer_bytes(wino, r + 1, 64, 64) > tile_kernel.MAX_SMEM_BYTES
    assert tile_kernel.fit_r(wino, 3, 3, 8) == 3
    with pytest.raises(ValueError, match="R=1"):
        tile_kernel.fit_r(wino, 4, 4096, 4096)


def test_epilogue_encoding_matches_elementwise_ops():
    b0, b1 = torch.ones(4), torch.full((4,), 2.0)
    tags, rows = registry.ElementwiseOps(
        (("bias", b0), ("relu",), ("bias", b1))
    ).kernel_form()
    assert tags == (("bias", 0), ("relu",), ("bias", 1))
    assert tuple(rows.shape) == (2, 4)
    n, word = tile_kernel.encode_epilogue(tags, rows.shape[0])
    assert n == 3 and word == 0 | (15 << 4) | (1 << 8)
    with pytest.raises(ValueError):
        tile_kernel.encode_epilogue((("bias", 2),), 2)


def test_f64_raises_unsupported():
    tr = transforms.WinogradTransform(m=3, k=3)
    x = torch.zeros((1, 8, 8, 2), dtype=torch.float64)
    with pytest.raises(ft.UnsupportedSpec):
        ft.conv2d_fused_tile(x, torch.zeros((3, 3, 2, 2)), tr, pad=1, device="cpu")


def test_ctypes_binding_matches_the_c_signature():
    """The ctypes argtypes list mirrors `fused_tile_launch` in the CUDA
    source one for one (the source cannot be compiled here)."""
    import ctypes
    import re

    src = tile_kernel.SOURCE.read_text()
    params = re.search(r'extern "C" int fused_tile_launch\((.*?)\)', src, re.S).group(1)
    kinds = []
    for p in (q.strip() for q in params.split(",")):
        if "*" in p:
            kinds.append(ctypes.c_void_p)
        elif p.startswith("unsigned long long"):
            kinds.append(ctypes.c_ulonglong)
        else:
            assert p.startswith("int "), p
            kinds.append(ctypes.c_int)
    assert kinds == list(tile_kernel.ARGTYPES)


@pytest.mark.parametrize("algo", ("auto", "direct", "l3_fused", "fft_fused", "three_stage"))
@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 2)])
def test_conv2d_dispatcher_matches_reference(algo, stride, groups):
    """`conv2d` plans through the registry with the same model numbers
    and runs the same algorithm as the reference dispatcher."""
    from repro.core import analysis as ref_analysis
    from repro.core import conv2d as ref_conv2d
    from repro_torch.core import analysis, conv2d

    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 16, 16, 4)) * 0.1).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 4 // groups, 6)) * 0.1).astype(np.float32)
    kw = dict(pad=1, stride=stride, groups=groups, algo=algo)
    y = conv2d(x, wk, hw=analysis.SKYLAKE_X, device="cpu", **kw)
    ref = ref_conv2d(jnp.asarray(x), jnp.asarray(wk), hw=ref_analysis.SKYLAKE_X, **kw)
    assert tuple(y.shape) == tuple(ref.shape)
    assert _rel(y.numpy(), ref) < TOL
