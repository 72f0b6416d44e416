"""The CUDA kernels on the card, against their plain PyTorch versions:
the tile kernel, and the LM path's conv1d, flash-attention and decode-MLP
kernels.

Skips on a host without a CUDA card (the kernels have no CPU mode).  It
imports neither JAX nor the reference package, so on the GPU machine it
runs without them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerance: rel < 1e-5 against the plain version (both fp32, summed in
different orders).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import registry, tiling, transforms
from repro_torch.kernels import fused_tile as ft
from repro_torch.kernels.fused_tile import kernel as tile_kernel
from repro_torch.kernels.fused_tile import ops as tile_ops

CASES = {
    "winograd-f3": (transforms.WinogradTransform(m=3, k=3), 1),
    "winograd-f5-grouped": (transforms.WinogradTransform(m=5, k=3), 2),
    "fft-t8-grouped": (transforms.FFTTransform(t=8, k=3), 2),
    "fft-t16": (transforms.FFTTransform(t=16, k=3), 1),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tile kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(y, ref):
    return float((y - ref).abs().max() / (ref.abs().max() + 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda_device, case, monkeypatch):
    """On a CUDA tensor `conv2d_fused_tile` launches the kernel exactly
    once -- never the plain version -- and agrees with the plain version
    run on the CPU."""
    tr, groups = CASES[case]
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, 37, 29, 6)) * 0.1, dtype=torch.float32)
    wk = torch.tensor(
        rng.standard_normal((3, 3, 6 // groups, 10)) * 0.1, dtype=torch.float32
    )
    bvec = torch.tensor(rng.standard_normal(10) * 0.1, dtype=torch.float32)
    ep = registry.ElementwiseOps((("bias", bvec), ("relu",)))
    plain = ft.conv2d_fused_tile(
        x, wk, tr, pad=1, groups=groups, epilogue=ep, device="cpu"
    )

    def no_fallback(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tile_ops._matrix, "matrix_tile_conv", no_fallback)
    ep_dev = registry.ElementwiseOps((("bias", bvec.to(cuda_device)), ("relu",)))
    before = tile_kernel.LAUNCHES
    y = ft.conv2d_fused_tile(
        x, wk, tr, pad=1, groups=groups, epilogue=ep_dev, device=cuda_device,
        blocks=ft.BlockConfig(r=3),
    )
    torch.cuda.synchronize()
    assert tile_kernel.LAUNCHES == before + 1
    assert y.device.type == "cuda" and tuple(y.shape) == tuple(plain.shape)
    assert _rel(y.cpu(), plain) < 1e-5


# --------------------------------------------------------- the LM kernels


def _counted(kernel_mod, fn):
    """Run `fn`, synchronize, and return (result, launches it made)."""
    before = kernel_mod.LAUNCHES
    y = fn()
    torch.cuda.synchronize()
    return y, kernel_mod.LAUNCHES - before


def test_cuda_conv1d_matches_plain(cuda_device):
    """A column slice of a wider activation (Mamba's xBC), L not a multiple
    of the strip, SiLU: one launch, rel < 1e-5 against the plain version."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

    rng = np.random.default_rng(3)
    wide = torch.tensor(rng.standard_normal((3, 300, 200)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((4, 72)) * 0.5, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(72) * 0.1, dtype=torch.float32)
    ref = conv1d_ref(wide[..., 64:136], w, b)
    wide_d, w_d, b_d = (t.to(cuda_device) for t in (wide, w, b))
    y, n = _counted(conv1d_kernel, lambda: conv1d_fused(wide_d[..., 64:136], w_d, b_d, lb=128))
    assert n == 1 and y.device.type == "cuda"
    assert _rel(y.cpu(), ref) < 1e-5


@pytest.mark.parametrize("hkv,window", [(1, 0), (1, 24), (4, 0), (2, 7)])
def test_cuda_flash_attention_matches_plain(cuda_device, hkv, window):
    """The model's (B, S, H, hd) layout passed as (B, H, S, hd) views, S not
    a multiple of the kernel's tiles, GQA g = 4 / 2 / 1, window on and off."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    rng = np.random.default_rng(4)
    mk = lambda h: torch.tensor(rng.standard_normal((2, 97, h, 64)), dtype=torch.float32)
    q, k, v = mk(4), mk(hkv), mk(hkv)
    views = lambda *ts: [t.transpose(1, 2) for t in ts]
    ref = attention_ref(*views(q, k, v), window=window)
    qd, kd, vd = views(*(t.to(cuda_device) for t in (q, k, v)))
    y, n = _counted(flash_kernel, lambda: flash_attention(qd, kd, vd, window=window))
    assert n == 1 and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y.cpu(), ref) < 1e-5


def test_cuda_decode_mlp_matches_plain(cuda_device):
    """B and d_ff not multiples of the kernel's row and column blocks."""
    from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref
    from repro_torch.kernels.decode_mlp import kernel as mlp_kernel

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((11, 96)), dtype=torch.float32)
    ws = [torch.tensor(rng.standard_normal(s) * 0.1, dtype=torch.float32)
          for s in ((96, 300), (96, 300), (300, 96))]
    ref = decode_mlp_ref(x, *ws)
    xd, wd = x.to(cuda_device), [w.to(cuda_device) for w in ws]
    y, n = _counted(mlp_kernel, lambda: decode_mlp(xd, *wd))
    assert n == 1
    assert _rel(y.cpu(), ref) < 1e-5


FLASH_SHAPES = {
    # name: (B, Hq, Hkv, Sq, Sk, hd, causal, window, model layout)
    "gemma3-global-B4-S700-hd256": (4, 4, 1, 700, 700, 256, True, 0, True),
    "gemma3-local-w512-B4-S700-hd256": (4, 4, 1, 700, 700, 256, True, 512, True),
    "noncausal-hd128-Sq77-Sk256": (1, 2, 1, 77, 256, 128, False, 0, False),
    "hd16-w8": (1, 4, 1, 33, 33, 16, True, 8, False),
    "hd32-w40-Sq50-Sk200": (2, 8, 2, 50, 200, 32, True, 40, False),
    "masked-rows-Sq200-Sk50-w40": (1, 2, 1, 200, 50, 64, True, 40, False),
}


@pytest.mark.parametrize("name", sorted(FLASH_SHAPES))
def test_cuda_flash_attention_at_served_and_edge_shapes(cuda_device, name):
    """The served gemma3 layers in the model's layout, a non-causal ragged
    Sk, the small head dims with a window, and rows past Sk + window that
    see no key (exactly 0): one launch, rel < 1e-5 against the plain
    version on the same card tensors."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    b, hq, hkv, sq, sk, hd, causal, window, model_layout = FLASH_SHAPES[name]
    rng = np.random.default_rng(8)

    def mk(h, s):
        shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
        t = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda_device)
        return t.transpose(1, 2) if model_layout else t

    q, k, v = mk(hq, sq), mk(hkv, sk), mk(hkv, sk)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    y, n = _counted(flash_kernel, lambda: flash_attention(q, k, v, causal=causal, window=window))
    assert n == 1 and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y, ref) < 1e-5
    if sq > sk + window > window:  # rows i >= sk + window - 1 see no key
        assert torch.equal(y[:, :, sk + window - 1:], torch.zeros_like(y[:, :, sk + window - 1:]))


def test_cuda_flash_attention_launches_at_every_head_dim(cuda_device):
    """Every instantiation's shared memory is accepted by the card (the
    source also checks it against sm_90's limit when it compiles): one
    launch per head dim, rel < 1e-5 against the plain version."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    rng = np.random.default_rng(11)
    for hd in flash_kernel.HEAD_DIMS:
        q, k, v = (torch.tensor(rng.standard_normal((1, 2, 70, hd)), dtype=torch.float32,
                                device=cuda_device) for _ in range(3))
        ref = attention_ref(q, k, v, causal=True, window=0)
        y, n = _counted(flash_kernel, lambda: flash_attention(q, k, v, causal=True, window=0))
        assert n == 1 and _rel(y, ref) < 1e-5, hd


def _mlp_operands(b, d, f, dev, seed):
    rng = np.random.default_rng(seed)
    mk = lambda shape, s: torch.tensor(rng.standard_normal(shape) * s, dtype=torch.float32,
                                       device=dev)
    return mk((b, d), 1.0), mk((d, f), d ** -0.5), mk((d, f), d ** -0.5), mk((f, d), f ** -0.5)


@pytest.mark.parametrize("b,d,f", [(4, 1152, 6912), (1, 1152, 6912), (11, 200, 700), (3, 64, 33)])
def test_cuda_decode_mlp_at_served_and_ragged_shapes(cuda_device, b, d, f):
    """gemma3-1b's decode MLP at B 4 and 1, a ragged B and f, and f not a
    multiple of 4 (single-float units): one launch, rel < 1e-5."""
    from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref
    from repro_torch.kernels.decode_mlp import kernel as mlp_kernel

    x, w1, w3, w2 = _mlp_operands(b, d, f, cuda_device, seed=9)
    ref = decode_mlp_ref(x, w1, w3, w2)
    y, n = _counted(mlp_kernel, lambda: decode_mlp(x, w1, w3, w2))
    assert n == 1 and tuple(y.shape) == (b, d)
    assert _rel(y, ref) < 1e-5


def test_cuda_decode_mlp_is_bitwise_deterministic(cuda_device):
    """Two calls on the same inputs give the same bits: the partials are
    summed in a fixed order, never by float atomics."""
    from repro_torch.kernels.decode_mlp import decode_mlp

    x, w1, w3, w2 = _mlp_operands(4, 1152, 6912, cuda_device, seed=10)
    y1, y2 = decode_mlp(x, w1, w3, w2), decode_mlp(x, w1, w3, w2)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def test_cuda_decode_mlp_refuses_a_geometry_that_disagrees_with_the_source(cuda_device):
    """The wrapper's geometry is accepted as it is; the same geometry with
    a shared-memory size off the source's layout, or too few blocks to
    cover d_ff, is refused before anything runs."""
    import ctypes
    import dataclasses

    from repro_torch.kernels.decode_mlp import kernel as mlp_kernel

    b, d, f = 4, 1152, 6912
    x, w1, w3, w2 = _mlp_operands(b, d, f, cuda_device, seed=12)
    g = mlp_kernel.launch_geometry(b, d, f)
    part = torch.empty((g.n_blocks, b, d), dtype=torch.float32, device=cuda_device)
    out = torch.empty((b, d), dtype=torch.float32, device=cuda_device)

    def launch(geo):
        args = geo.launch_args(b, d, f)
        mlp_kernel.LIB.launch("decode_mlp_launch", x.device, x.data_ptr(), w1.data_ptr(),
                              w3.data_ptr(), w2.data_ptr(), part.data_ptr(), out.data_ptr(),
                              ctypes.addressof(args))

    launch(g)
    torch.cuda.synchronize()
    for bad in (dataclasses.replace(g, smem=g.smem + 16),
                dataclasses.replace(g, n_blocks=g.n_blocks // 2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(bad)


# ------------------------------------------- the tile kernel at served shapes

SERVED = {
    # label: (transform, batch, h, w, c_in, c_out, groups, bias_relu)
    "vgg-64to64-at64": (transforms.WinogradTransform(m=5, k=3), 4, 64, 64, 64, 64, 1, False),
    "fft-8to8-at64-bias-relu": (transforms.FFTTransform(t=16, k=3), 4, 64, 64, 8, 8, 1, True),
    "vgg-256to256-at16": (transforms.WinogradTransform(m=5, k=3), 4, 16, 16, 256, 256, 1, False),
}


def _served_operands(tr, b, h, w, c_in, c_out, groups, bias_relu, dev, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, h, w, c_in)) * 0.1,
                     dtype=torch.float32, device=dev)
    wk = torch.tensor(rng.standard_normal((3, 3, c_in // groups, c_out)) * 0.1,
                      dtype=torch.float32, device=dev)
    bvec = torch.tensor(rng.standard_normal(c_out) * 0.1, dtype=torch.float32, device=dev)
    ep = registry.ElementwiseOps((("bias", bvec), ("relu",))) if bias_relu else None
    return x, wk, ep


@pytest.mark.parametrize("case", sorted(SERVED))
def test_cuda_tile_kernel_at_served_shapes(cuda_device, case):
    """The served path's entry point at full width: one launch, rel < 1e-5
    against the plain version on the same card tensors."""
    tr, b, h, w, c_in, c_out, groups, bias_relu = SERVED[case]
    x, wk, ep = _served_operands(tr, b, h, w, c_in, c_out, groups, bias_relu,
                                 cuda_device, seed=6)
    spec = tr.kernel_spec()
    plan = tiling.TilePlan.build(h, w, tr.k, 1, tr.t)
    ref = ft.matrix_tile_conv(
        tiling.pad_input(x, plan), spec.pack_rhs(tr.kernel_transform(wk), groups),
        plan, spec, groups=groups, epilogue=ep,
    )
    y, n = _counted(tile_kernel, lambda: ft.conv2d_fused_tile(
        x, wk, tr, pad=1, groups=groups, epilogue=ep, device=cuda_device,
        blocks=ft.BlockConfig(r=8),
    ))
    assert n == 1 and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y, ref) < 1e-5


@pytest.mark.parametrize("family,groups", [("winograd", 1), ("fft", 2)])
def test_cuda_tile_kernel_ragged_slab_and_width(cuda_device, family, groups):
    """C' = 20 in slabs of 8 (the last slab masked), W = 29 (a ragged last
    tile column), R not dividing the tile count; FFT also split over S."""
    tr = (transforms.WinogradTransform(m=5, k=3) if family == "winograd"
          else transforms.FFTTransform(t=16, k=3))
    x, wk, ep = _served_operands(tr, 3, 37, 29, 6, 20, groups, True, cuda_device, seed=7)
    spec = tr.kernel_spec()
    plan = tiling.TilePlan.build(37, 29, tr.k, 1, tr.t)
    rhs = spec.pack_rhs(tr.kernel_transform(wk), groups)
    xp = tiling.pad_input(x, plan).contiguous()
    ref = ft.matrix_tile_conv(xp, rhs, plan, spec, groups=groups, epilogue=ep)
    tags, biases = ep.kernel_form()
    geo = tile_kernel.Geometry(r=3, ns=8, sc=4, n_split=1 if family == "winograd" else 3,
                               na=tile_kernel.pick_na(spec, 3, 8))
    y, n = _counted(tile_kernel, lambda: tile_kernel.fused_tile_call(
        xp, rhs, biases.contiguous(), spec=spec, n_tiles_h=plan.n_tiles_h,
        n_tiles_w=plan.n_tiles_w, r=3, groups=groups, ep_ops=tags, geometry=geo,
    ))
    y = y[:, : plan.h_out, : plan.w_out]
    assert n == 1 and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y, ref) < 1e-5
