"""The CUDA kernels on the card, against their plain PyTorch versions:
the tile kernel, and the LM path's conv1d, flash-attention and decode-MLP
kernels; and the mixture-of-experts layer on the card against the CPU.

Skips on a host without a CUDA card (the kernels have no CPU mode); the
tests that launch on cuda:1 after cuda:0 (`two_cards`) skip with fewer
than two cards.  It imports neither JAX nor the reference package, so on
the GPU machine it runs without them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerance: rel < 1e-5 against the plain version (both fp32, summed in
different orders); the flash backward's dq, dk, dv rel < 5e-5 against
the plain backward fed the same o and lse (the reference's gradient
tolerance; it runs on split-TF32 tensor cores; rel < 1e-5 at
seamless-m4t-medium's training shapes and through `FlashAttention` at
non-causal Sq != Sk), the training loss on the card against the CPU rel 1e-4 and
its gradients rel 1e-3 (the reference's net-level tolerance); the conv1d
backward's dx, dw, db rel < 1e-5 against `conv1d_bwd_ref` (both fp32).
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


def _conv1d_operands(b, length, d, k, row, offset, dev, seed):
    """x (B, L, D) as columns offset..offset+D of a (B, L, row) tensor on
    `dev`, w (K, D), bias (D,)."""
    rng = np.random.default_rng(seed)
    mk = lambda shape, s: torch.tensor(rng.standard_normal(shape) * s, dtype=torch.float32,
                                       device=dev)
    wide = mk((b, length, row), 1.0)
    return wide[..., offset:offset + d], mk((k, d), 0.5), mk((d,), 0.1)


CONV1D_SHAPES = {
    # name: (B, L, D, K, row stride, column offset, activation)
    "mamba2-wave1-B4-L768": (4, 768, 4352, 4, 8512, 4096, "silu"),
    "mamba2-wave2-B2-L129": (2, 129, 4352, 4, 8512, 4096, "silu"),
    "unaligned-offset65-D71": (2, 300, 71, 4, 200, 65, "silu"),
    "L1": (3, 1, 64, 4, 64, 0, "silu"),
    "L5-below-a-strip": (3, 5, 64, 3, 64, 0, "none"),
    "L13-ragged-strip": (2, 13, 100, 4, 100, 0, "none"),
}


@pytest.mark.parametrize("name", sorted(CONV1D_SHAPES))
def test_cuda_conv1d_at_served_and_edge_shapes(cuda_device, name):
    """mamba2-1.3b's two prefill waves (the xBC slice of the 8512-wide
    in-projection, float4 units), a slice at column 65 (not 16-byte
    aligned: one channel per thread), L 1, L shorter than a strip and L
    ending inside one: one launch, rel < 1e-5 against the plain version."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

    b, length, d, k, row, offset, act = CONV1D_SHAPES[name]
    x, w, bias = _conv1d_operands(b, length, d, k, row, offset, cuda_device, seed=20)
    y, n = _counted(conv1d_kernel, lambda: conv1d_fused(x, w, bias, activation=act))
    assert n == 1 and tuple(y.shape) == (b, length, d)
    assert _rel(y, conv1d_ref(x, w, bias, activation=act)) < 1e-5
    geo = conv1d_kernel.launch_geometry(b, length, d, row, aligned=x.data_ptr() % 16 == 0)
    assert geo.vec == (1 if offset % 4 else 4)


@pytest.mark.parametrize("k, act, lo", [
    (4, "silu", 4096), (4, "none", 4096), (9, "silu", 4096), (16, "silu", 4096),
    (1, "silu", 4096), (4, "silu", 65)])
def test_cuda_conv1d_backward_matches_plain(cuda_device, k, act, lo):
    """Autograd through `Conv1dFused` on a strided column slice (rows 8512
    floats apart, mamba2's zxbcdt; at column 65 not 16-byte aligned, one
    channel a thread): the forward launches the kernel once, the backward
    the backward kernel once (K 9 and 16: its any-K instance), dx, dw, db
    agree with `conv1d_bwd_ref` on the same card tensors within rel 1e-5
    and are the same bits on a second run; dx lands in the slice of the
    wide gradient and nowhere else."""
    from repro_torch.kernels.conv1d_fused import backward as conv_backward
    from repro_torch.kernels.conv1d_fused import compare as conv_compare
    from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref, conv1d_fused
    from repro_torch.kernels.conv1d_fused import kernel as conv_kernel

    gen = np.random.default_rng(40 + k)
    wide = torch.tensor(gen.standard_normal((2, 300, 8512)), dtype=torch.float32,
                        device=cuda_device, requires_grad=True)
    d = 4352
    w = torch.tensor(gen.standard_normal((k, d)) * 0.5, dtype=torch.float32,
                     device=cuda_device, requires_grad=True)
    b = torch.tensor(gen.standard_normal(d) * 0.1, dtype=torch.float32,
                     device=cuda_device, requires_grad=True)
    g = torch.tensor(gen.standard_normal((2, 300, d)), dtype=torch.float32,
                     device=cuda_device)
    f0, b0 = conv_kernel.LAUNCHES, conv_backward.LAUNCHES
    y = conv1d_fused(wide[..., lo:lo + d], w, b, activation=act)
    assert (conv_kernel.LAUNCHES - f0, conv_backward.LAUNCHES - b0) == (1, 0)
    dwide, dw, db = torch.autograd.grad(y, (wide, w, b), g, retain_graph=True)
    again = torch.autograd.grad(y, (wide, w, b), g)
    torch.cuda.synchronize()
    assert (conv_kernel.LAUNCHES - f0, conv_backward.LAUNCHES - b0) == (1, 2)
    want = conv1d_bwd_ref(g, wide.detach()[..., lo:lo + d], w.detach(), b.detach(),
                          activation=act)
    assert _rel(dwide[..., lo:lo + d], want[0]) < 1e-5
    assert _rel(dw, want[1]) < 1e-5 and _rel(db, want[2]) < 1e-5
    assert not dwide[..., :lo].any() and not dwide[..., lo + d:].any()
    assert all(torch.equal(a, r) for a, r in zip((dwide, dw, db), again))


@pytest.mark.parametrize("k", [*range(1, 9), 9, 16])
def test_cuda_conv1d_every_tap_count(cuda_device, k):
    """Every instantiated K and the any-K instance at K 9 and 16 (a halo
    over one and two strips), float4 units, L ragged against the strips."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

    x, w, bias = _conv1d_operands(2, 203, 256, k, 256, 0, cuda_device, seed=21 + k)
    y, n = _counted(conv1d_kernel, lambda: conv1d_fused(x, w, bias))
    assert n == 1
    assert _rel(y, conv1d_ref(x, w, bias)) < 1e-5


def test_cuda_conv1d_is_bitwise_deterministic_and_ignores_lb(cuda_device):
    """Two calls give the same bits, and so does every `lb` (the
    reference's L block sets nothing on the card)."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused

    x, w, bias = _conv1d_operands(4, 768, 4352, 4, 8512, 4096, cuda_device, seed=30)
    y0 = conv1d_fused(x, w, bias)
    ys = [conv1d_fused(x, w, bias, lb=lb) for lb in (16, 128, 1024)]
    torch.cuda.synchronize()
    assert all(torch.equal(y0, y) for y in ys)


def test_cuda_conv1d_refuses_a_geometry_that_does_not_cover_the_work(cuda_device):
    """The wrapper's geometry is accepted as it is; one strip or one
    channel block short, or float4 units on a slice that is not 16-byte
    aligned, is refused before anything runs."""
    import ctypes
    import dataclasses

    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

    x, w, bias = _conv1d_operands(2, 129, 256, 4, 260, 1, cuda_device, seed=31)
    out = torch.empty((2, 129, 256), dtype=torch.float32, device=cuda_device)
    g = conv1d_kernel.launch_geometry(2, 129, 256, 260, aligned=False)

    def launch(geo):
        args = geo.launch_args(129, 256, 260, 4, True)
        conv1d_kernel.LIB.launch("conv1d_fused_launch", x.device, x.data_ptr(), w.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), ctypes.addressof(args))

    launch(g)
    torch.cuda.synchronize()
    for bad in (dataclasses.replace(g, n_strips=g.n_strips - 1),
                dataclasses.replace(g, n_cblocks=g.n_cblocks - 1),
                dataclasses.replace(g, vec=4, n_cblocks=1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(bad)


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
    "moonshot-B4-H16-S700-hd128": (4, 16, 16, 700, 700, 128, True, 0, True),
    # seamless-m4t-medium (MHA, hd 64): the encoder's bidirectional
    # self-attention over 1024 frames, the decoder's causal self-attention
    # (the 128-token prompt, the training S 512), the cross attention at
    # prefill, at a decode step (one q row in a 64-row tile) and in training
    "seamless-encoder-B4-H16-S1024-hd64": (4, 16, 16, 1024, 1024, 64, False, 0, True),
    "seamless-decoder-self-B4-H16-S128-hd64": (4, 16, 16, 128, 128, 64, True, 0, True),
    "seamless-decoder-self-B4-H16-S512-hd64": (4, 16, 16, 512, 512, 64, True, 0, True),
    "seamless-cross-B4-H16-Sq512-Sk1024-hd64": (4, 16, 16, 512, 1024, 64, False, 0, True),
    "seamless-cross-B4-H16-Sq128-Sk1024-hd64": (4, 16, 16, 128, 1024, 64, False, 0, True),
    "seamless-cross-decode-B4-H16-Sq1-Sk1024-hd64": (4, 16, 16, 1, 1024, 64, False, 0, True),
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
    launch per (hd, vd) pair, rel < 1e-5 against the plain version."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    rng = np.random.default_rng(11)
    for hd, vd in flash_kernel.HEAD_DIMS:
        q, k, v = (torch.tensor(rng.standard_normal((1, 2, 70, d)), dtype=torch.float32,
                                device=cuda_device) for d in (hd, hd, vd))
        ref = attention_ref(q, k, v, causal=True, window=0)
        y, n = _counted(flash_kernel, lambda: flash_attention(q, k, v, causal=True, window=0))
        assert n == 1 and tuple(y.shape) == (1, 2, 70, vd) and _rel(y, ref) < 1e-5, (hd, vd)


REPAIRED_HEAD_DIMS = {
    # name: (B, Hq, Hkv, Sq, Sk, hd, causal, window, model layout)
    "stablelm-3b-hd80-causal": (2, 32, 32, 300, 300, 80, True, 0, True),
    "hd80-gqa4-w40-ragged": (1, 8, 2, 97, 97, 80, True, 40, False),
    "zamba2-hd112-causal-w512": (1, 32, 32, 600, 600, 112, True, 512, True),
    "zamba2-hd112-noncausal": (1, 32, 32, 77, 256, 112, False, 0, False),
}


@pytest.mark.parametrize("name", sorted(REPAIRED_HEAD_DIMS))
def test_cuda_flash_attention_at_head_dims_80_and_112(cuda_device, name):
    """stablelm-3b's and zamba2-7b's head dims (chunks of 8 columns, 5 and
    7 per warp of a pair): one launch, rel < 1e-5 against the plain
    version."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    b, hq, hkv, sq, sk, hd, causal, window, model_layout = REPAIRED_HEAD_DIMS[name]
    rng = np.random.default_rng(14)

    def mk(h, s):
        shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
        t = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda_device)
        return t.transpose(1, 2) if model_layout else t

    q, k, v = mk(hq, sq), mk(hkv, sk), mk(hkv, sk)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    y, n = _counted(flash_kernel, lambda: flash_attention(q, k, v, causal=causal, window=window))
    assert n == 1 and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y, ref) < 1e-5


@pytest.mark.parametrize("hd", [256, 80])
def test_cuda_flash_attention_is_bitwise_deterministic(cuda_device, hd):
    """Two calls on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(15)
    q, k, v = (torch.tensor(rng.standard_normal((2, 4, 300, hd)), dtype=torch.float32,
                            device=cuda_device) for _ in range(3))
    y1 = flash_attention(q, k, v, causal=True, window=0)
    y2 = flash_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def test_cuda_flash_attention_refuses_an_unregistered_head_dim(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros((1, 2, 16, 48), device=cuda_device)
    with pytest.raises(ValueError, match="instantiations"):
        flash_attention(q, q, q, causal=True, window=0)


@pytest.mark.parametrize("hd,vd", [(128, 192), (192, 192), (56, 64), (48, 48)])
def test_cuda_flash_kernels_refuse_a_pair_with_no_instantiation(cuda_device, hd, vd):
    """A (q/k, v) head-dim pair the kernels have no instantiation for is
    refused by the forward and the backward, with a message that names the
    pairs they have (MLA's (192, 128) and the MTP block's (56, 56) among
    them)."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    q, k = (torch.zeros((1, 2, 16, hd), device=cuda_device) for _ in range(2))
    v, o = (torch.zeros((1, 2, 16, vd), device=cuda_device) for _ in range(2))
    lse = torch.zeros((1, 2, 16), device=cuda_device)
    for call in (lambda: flash_kernel.flash_attention_call(q, k, v, causal=True, window=0),
                 lambda: bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, o, causal=True,
                                                             window=0)):
        with pytest.raises(ValueError, match=r"instantiations .*\(192, 128\).*") as err:
            call()
        assert "(56, 56)" in str(err.value)


# deepseek-v3-671b: MLA's prefill / training attention (q/k hd 192 = nope 128
# + rope 64, v hd 128, scale 192^-0.5) and its MTP block's (hd 56, padded to
# 64 in the kernels' tiles), in the model's (B, S, H, hd) layout
SPLIT_SHAPES = {
    # name: (B, Hq, Hkv, Sq, Sk, hd, vd, causal, window, model layout)
    "mla-prefill-B4-H128-S700": (4, 128, 128, 700, 700, 192, 128, True, 0, True),
    "mtp-B4-H128-S1023-hd56": (4, 128, 128, 1023, 1023, 56, 56, True, 0, True),
    "mla-g1-masked-rows-Sq200-Sk50-w40": (1, 4, 4, 200, 50, 192, 128, True, 40, True),
    "mtp-g1-masked-rows-Sq200-Sk50-w40": (1, 4, 4, 200, 50, 56, 56, True, 40, True),
    "mla-g4-noncausal-Sq77-Sk256": (1, 8, 2, 77, 256, 192, 128, False, 0, False),
    "mtp-g2-w24-ragged-S97": (2, 8, 4, 97, 97, 56, 56, True, 24, False),
}


def _split_operands(shape, dev, seed):
    b, hq, hkv, sq, sk, hd, vd, _, _, model_layout = shape
    rng = np.random.default_rng(seed)

    def mk(h, s, d):
        t = torch.tensor(rng.standard_normal((b, s, h, d) if model_layout else (b, h, s, d)),
                         dtype=torch.float32, device=dev)
        return t.transpose(1, 2) if model_layout else t

    return mk(hq, sq, hd), mk(hkv, sk, hd), mk(hkv, sk, vd), mk(hq, sq, vd)


@pytest.mark.parametrize("name", sorted(SPLIT_SHAPES))
def test_cuda_flash_attention_at_split_and_padded_head_dims(cuda_device, name):
    """One launch; o (B, Hq, Sq, vd) in q's layout within rel 1e-5 of the
    plain version, bitwise the same with the lse written, the lse within
    rel 1e-5 of `lse_ref`; rows past Sk + window that see no key give
    exactly 0 (and an lse of 0)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention, lse_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    shape = SPLIT_SHAPES[name]
    b, hq, hkv, sq, sk, hd, vd, causal, window, model_layout = shape
    q, k, v, _ = _split_operands(shape, cuda_device, seed=16)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    y, n = _counted(flash_kernel, lambda: flash_attention(q, k, v, causal=causal, window=window))
    y2, lse = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                                return_lse=True)
    torch.cuda.synchronize()
    assert n == 1 and tuple(y.shape) == (b, hq, sq, vd) == tuple(ref.shape)
    assert (y.stride(1) < y.stride(2)) == model_layout  # q's layout
    assert _rel(y, ref) < 1e-5
    assert torch.equal(y, y2)
    want = lse_ref(q, k, causal=causal, window=window)
    assert float((lse - want).abs().max() / want.abs().max()) < 1e-5
    if sq > sk + window > window:  # rows i >= sk + window - 1 see no key
        assert not y[:, :, sk + window - 1:].any() and not lse[:, :, sk + window - 1:].any()


@pytest.mark.parametrize("name", sorted(SPLIT_SHAPES))
def test_cuda_flash_backward_at_split_and_padded_head_dims(cuda_device, name):
    """dq, dk (hd wide) and dv (vd wide) within rel 5e-5 of the plain
    backward fed the same o and lse, one launch, two runs bitwise equal;
    rows that see no key get a dq of exactly 0."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    shape = SPLIT_SHAPES[name]
    b, hq, hkv, sq, sk, hd, vd, causal, window, _ = shape
    q, k, v, do = _split_operands(shape, cuda_device, seed=17)
    err, n, (dq, dk, dv) = _flash_bwd_check(q, k, v, do, causal, window)
    assert n == 1 and err < FLASH_BWD_REL, (name, err)
    assert (tuple(dq.shape), tuple(dk.shape), tuple(dv.shape)) == (
        (b, hq, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, vd))
    o, lse = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                               return_lse=True)
    again = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=causal,
                                                window=window)
    a2 = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(again, a2))
    if sq > sk + window > window:
        assert dq[:, :, sk + window - 1:].count_nonzero() == 0


def _mlp_operands(b, d, f, dev, seed):
    rng = np.random.default_rng(seed)
    mk = lambda shape, s: torch.tensor(rng.standard_normal(shape) * s, dtype=torch.float32,
                                       device=dev)
    return mk((b, d), 1.0), mk((d, f), d ** -0.5), mk((d, f), d ** -0.5), mk((f, d), f ** -0.5)


@pytest.mark.parametrize("b,d,f", [(4, 1152, 6912), (1, 1152, 6912), (11, 200, 700), (3, 64, 33),
                                   (4, 1024, 4096)])
def test_cuda_decode_mlp_at_served_and_ragged_shapes(cuda_device, b, d, f):
    """gemma3-1b's decode MLP at B 4 and 1, a ragged B and f, f not a
    multiple of 4 (single-float units), and seamless-m4t-medium's decoder
    MLP at B 4: one launch, rel < 1e-5."""
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


# ------------------------------------------- replicas on streams of their own


def test_cuda_phase_hook_reports_the_launched_geometry(cuda_device):
    """The phase hook's geometry on the card is the one the kernel
    launched: that of the call's memoised `kernel.launch_plan`."""
    tr = transforms.WinogradTransform(m=5, k=3)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 37, 29, 6)) * 0.1, dtype=torch.float32)
    wk = torch.tensor(rng.standard_normal((3, 3, 6, 10)) * 0.1, dtype=torch.float32)
    seen = []
    tile_kernel._PLANS.clear()
    prev = tile_ops.set_phase_hook(lambda phase, info: seen.append((phase, info)))
    try:
        ft.conv2d_fused_tile(x, wk, tr, pad=1, device=cuda_device,
                             blocks=ft.BlockConfig(r=3))
    finally:
        tile_ops.set_phase_hook(prev)
    torch.cuda.synchronize()
    (launched,) = tile_kernel._PLANS.values()
    g = launched.geo
    assert [p for p, _ in seen] == list(tile_ops._PHASES)
    for _, info in seen:
        assert info["backend"] == "torch-cuda"
        assert (info["r"], info["ns"], info["sc"], info["n_split"], info["na"]) == (
            g.r, g.ns, g.sc, g.n_split, g.na)
        assert info["blocks"] == g.blocks(2 * info["n_tiles_h"] * info["n_tiles_w"], 10)


def test_cuda_replica_streams_are_bitwise_the_serial_replica(cuda_device):
    """vgg_mixed_channel on two replicas of one `ReplicaPool`, each worker
    thread on its own CUDA stream, waves in flight together: every output
    is bitwise the one replica 0 gives running the same waves serially on
    the default stream, and both replicas served waves."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.convserve.runtime import (
        ReplicaPool, Request, RuntimeConfig, WaveScheduler, make_images, poisson_trace,
    )
    from repro_torch.core import analysis

    spec = vgg_mixed_channel(3)
    engine = Engine(hw=analysis.H100_SXM, device=cuda_device)
    pool = ReplicaPool.build(engine, spec, init_weights(spec, seed=0), n=2, input_hw=(64, 64))
    pool.warmup((32, 64), (4,))
    trace = poisson_trace(40.0, 24, seed=7, sizes=(32, 48, 64))
    images = make_images(trace, 3, seed=8)
    sched = WaveScheduler(spec, RuntimeConfig(max_batch=4, buckets=(32, 64), queue_depth=64))
    for a in trace:
        assert sched.admit(Request(rid=a.rid, image=images[a.rid]), now=0.0) is None
    waves = []
    while (w := sched.drain_wave()) is not None:
        waves.append(w)
    before = tile_kernel.LAUNCHES
    results = [f.result() for f in [pool.submit(w) for w in waves]]
    assert tile_kernel.LAUNCHES > before
    assert all(d > 0 for d in pool.stats()["dispatched"])
    ex0 = pool.executors[0]
    for w, res in zip(waves, results):
        serial = w.crop(spec, ex0(*w.assemble()).cpu().numpy())
        assert serial.keys() == res.outputs.keys()
        for rid, y in serial.items():
            assert np.array_equal(res.outputs[rid], y), rid
    from repro_torch.core import registry

    assert pool.cache.stats()["misses"] == sum(  # prepared once, in warmup
        registry.get(p.algo).consumes_wt for p in pool.executors[0].plan.layers)
    pool.shutdown()


# ------------------------------ l3_fused_pallas and the f64 scan oracle


def test_cuda_l3_fused_pallas_matches_plain(cuda_device):
    """`l3_fused_pallas` (the tile kernel under the reference's Winograd
    name) at vgg 64->64 @64 b4 F(5,3): one tile-kernel launch, rel <
    1e-5 against the plain version on the same card tensors."""
    from repro_torch.kernels.fused_winograd import conv2d_fused_pallas

    tr = transforms.WinogradTransform(m=5, k=3)
    x, wk, _ = _served_operands(tr, 4, 64, 64, 64, 64, 1, False, cuda_device, seed=9)
    spec = tr.kernel_spec()
    plan = tiling.TilePlan.build(64, 64, 3, 1, tr.t)
    ref = ft.matrix_tile_conv(tiling.pad_input(x, plan), spec.pack_rhs(tr.kernel_transform(wk)),
                              plan, spec)
    y, n = _counted(tile_kernel, lambda: conv2d_fused_pallas(
        x, wk, pad=1, m=5, r_tiles=8, device=cuda_device))
    assert n == 1 and tuple(y.shape) == tuple(ref.shape)
    assert _rel(y, ref) < 1e-5


@pytest.mark.parametrize("case", sorted(SERVED))
def test_cuda_tile_kernel_against_the_f64_scan_oracle(cuda_device, case):
    """The f32 tile kernel against `scan_tile_conv` in f64 on the card
    (the oracle use the reference built it for, called by name): rel <
    5e-5, the reference's tile-engine tolerance against direct.  Only the
    oracle call reaches the scan; an f64 tile conv on the card raises
    instead of turning to it."""
    from repro_torch.core import pipeline

    tr, b, h, w, c_in, c_out, groups, bias_relu = SERVED[case]
    x, wk, ep = _served_operands(tr, b, h, w, c_in, c_out, groups, bias_relu,
                                 cuda_device, seed=7)
    before = pipeline.SCAN_CALLS
    y, n = _counted(tile_kernel, lambda: pipeline.fused_tile_conv(
        x, wk, tr, pad=1, r_tiles=8, groups=groups, epilogue=ep))
    assert n == 1 and pipeline.SCAN_CALLS == before
    ep64 = None
    if ep is not None:
        ep64 = registry.ElementwiseOps(
            [(op[0], op[1].double()) if op[0] == "bias" else op for op in ep.ops])
    with pytest.raises(ft.UnsupportedSpec, match="f64"):
        pipeline.fused_tile_conv(x.double(), wk.double(), tr, pad=1, r_tiles=8,
                                 groups=groups, epilogue=ep64)
    assert pipeline.SCAN_CALLS == before
    oracle = pipeline.scan_tile_conv(
        x.double(), wk.double(), tr, pad=1, r_tiles=64, groups=groups, epilogue=ep64)
    torch.cuda.synchronize()
    assert pipeline.SCAN_CALLS == before + 1 and oracle.dtype == torch.float64
    assert _rel(y.double(), oracle) < 5e-5


# ------------------------- fused vs unfused, and the hot swap on streams


def _fft_fewchannel(cuda_device):
    from repro_torch.configs.convnets import fft_fewchannel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.core import analysis

    spec = fft_fewchannel(4)
    return spec, Engine(hw=analysis.H100_SXM, device=cuda_device), init_weights(spec, seed=0)


def test_cuda_fused_and_unfused_fft_fewchannel_are_bitwise_equal(cuda_device):
    """The adapt loop shadows a fusion-only candidate in bitwise mode: the
    seed plan's fused group (one super-tile, through `execute_staged`)
    and the same algorithms unfused must give the same bits on the card,
    on a ragged wave, with the same tile-kernel launches."""
    spec, engine, ws = _fft_fewchannel(cuda_device)
    fused = engine.compile(spec, ws, input_hw=(64, 64))
    assert fused.plan.groups and all(p.algo == "fft_fused" for p in fused.plan.layers)
    unfused = engine.compile(spec, ws, plan=fused.plan, fuse=False)
    assert not unfused.plan.groups and unfused.plan.algos() == fused.plan.algos()
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 64, 64, 4)) * 0.1).astype(np.float32)
    sizes = np.array([[64, 64], [48, 48]], np.int32)
    ya, na = _counted(tile_kernel, lambda: fused(x, sizes))
    yb, nb = _counted(tile_kernel, lambda: unfused(x, sizes))
    assert na == nb == 3
    assert torch.equal(ya, yb)


def test_cuda_hot_swap_on_two_streams(cuda_device):
    """fft_fewchannel on two replicas, each worker on its own stream, hot
    swapped mid-traffic to a candidate that keeps two layers' transforms
    and drops one: every request answered, the dropped layer's cache key
    gone and no other, and every wave dispatched after the swap (any wave
    holding a request submitted after it) bitwise what a fresh compile of
    the candidate gives on the same wave."""
    import dataclasses

    from repro_torch.convserve import Engine, hot_swap
    from repro_torch.convserve.plan import LayerPlan
    from repro_torch.convserve.runtime import (
        ReplicaPool, RuntimeConfig, ServeRuntime, make_images, poisson_trace,
    )

    spec, engine, ws = _fft_fewchannel(cuda_device)
    pool = ReplicaPool.build(engine, spec, ws, n=2, input_hw=(64, 64))
    assert pool.workers == 2
    rt = ServeRuntime(pool, RuntimeConfig(max_batch=4, buckets=(64,), queue_depth=64,
                                          slo_s=10.0, service_est_s=1e-3))
    rt.warmup()
    served = []
    rt.add_wave_observer(lambda res: served.append(res.wave))
    seed = pool.executors[0].plan
    l0 = seed.layers[0]
    direct = LayerPlan.from_algo_plan(
        l0.layer, registry.plan_conv(l0.spec, engine.hw, algo="direct"))
    cand_plan = dataclasses.replace(seed, layers=(direct,) + seed.layers[1:], groups=())
    cands = [engine.compile(spec, ws, plan=cand_plan, fuse=None) for _ in range(2)]
    old_keys = set(pool.executors[0].cache_keys())
    stale = old_keys - set(cands[0].cache_keys())
    assert len(stale) == 1 and old_keys - stale

    trace = poisson_trace(1000.0, 24, seed=5, sizes=(64,))
    images = make_images(trace, 4, seed=6)
    try:
        for a in trace[:12]:
            assert rt.submit(images[a.rid], rid=a.rid) is None
            rt.poll()
        old = hot_swap(pool, cands, scheduler=rt.scheduler, timeout_s=30.0)
        assert pool.executors == cands and len(old) == 2
        assert not stale & set(pool.cache.keys())
        assert old_keys - stale <= set(pool.cache.keys())
        for a in trace[12:]:
            assert rt.submit(images[a.rid], rid=a.rid) is None
            rt.poll()
        rt.drain()
    finally:
        rt.shutdown()
    assert sorted(rt.results) == [a.rid for a in trace] and not rt.errors
    fresh = Engine(hw=engine.hw, device=cuda_device).compile(spec, ws, plan=cand_plan, fuse=None)
    late = {a.rid for a in trace[12:]}
    after = [w for w in served if late & {r.rid for r in w.requests}]
    assert after
    for w in after:
        want = w.crop(spec, fresh(*w.assemble()).cpu().numpy())
        for rid, y in want.items():
            assert np.array_equal(rt.results[rid], y), rid


# ------------------------------------------------------------- the fleet


def _vgg_fleet(cuda_device, n=2, **kw):
    """vgg_mixed_channel on an ElasticPool at the served shapes (bucket
    64, waves of 8), warmed, under a SimClock."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.convserve.fleet import ElasticPool
    from repro_torch.convserve.runtime import SimClock
    from repro_torch.core import analysis

    torch.backends.cudnn.allow_tf32 = False
    spec = vgg_mixed_channel(3)
    pool = ElasticPool.build(
        Engine(hw=analysis.H100_SXM, device=cuda_device), spec,
        init_weights(spec, seed=0), n=n, clock=SimClock(), input_hw=(64, 64),
        startup_s=0.0, **kw)
    pool.warmup([64], [8])
    return spec, pool


def _probe_output(pool, ex):
    x, ext = pool._probe_batch(64)
    return ex(x, ext)[0].cpu().numpy()


def test_cuda_fleet_probe_sees_corruption_and_the_repair_is_bitwise(cuda_device):
    """On vgg at the served shapes, `corrupt_entry` changes the probe's
    output; `invalidate()` and a fresh fetch give back the golden probe
    bit for bit (otherwise every later probe would repair again), and
    the pool's own probe repairs exactly once."""
    spec, pool = _vgg_fleet(cuda_device)
    golden = pool._golden[64]
    ex = pool.executors[0]
    assert np.array_equal(_probe_output(pool, ex), golden)
    key = pool.cache.corrupt_entry()
    assert key is not None
    assert not np.array_equal(_probe_output(pool, ex), golden)
    doc = pool.probe()
    assert doc == {"probed": 2, "quarantined": 0, "cache_repaired": True}
    assert np.array_equal(_probe_output(pool, ex), golden)
    assert pool.probe() == {"probed": 2, "quarantined": 0, "cache_repaired": False}
    st = pool.stats()
    assert st["cache_repairs"] == 1 and st["probe_mismatches"] == 2


def test_cuda_fleet_replicas_and_a_grown_newcomer_probe_bitwise(cuda_device):
    """Two replicas and one grown later run the probe at the same shape
    with the same plan, shared cache and launch geometry: the same bits
    as the golden output, and the same tile-kernel launches each."""
    spec, pool = _vgg_fleet(cuda_device)
    golden = pool._golden[64]
    born = pool.grow(1)
    pool.advance(pool.clock.now())  # startup 0: the newcomer is READY
    assert born == [2] and pool.ready_count() == 3
    counts = []
    for ex in pool.executors:
        y, n = _counted(tile_kernel, lambda ex=ex: _probe_output(pool, ex))
        assert np.array_equal(y, golden)
        counts.append(n)
    assert len(set(counts)) == 1 and counts[0] > 0
    assert pool.probe()["probed"] == 3 and pool.stats()["probe_mismatches"] == 0


def test_cuda_sharded_vgg_wave_within_tolerance_of_the_unsharded(cuda_device):
    """A ragged vgg wave of 8 split into 4 shards on the logical path:
    within rel 1e-5 of the unsharded wave of the same plan (a shard may
    take another kernel geometry or GEMM algorithm)."""
    from repro_torch.convserve.fleet import ShardedWaveExecutor

    spec, pool = _vgg_fleet(cuda_device, n=1)
    net = pool.executors[0].net
    sharded = ShardedWaveExecutor(net, shards=4)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((8, 64, 64, 3)) * 0.1).astype(np.float32)
    sizes = np.array([[64, 64], [48, 48], [64, 64], [32, 32], [48, 48], [64, 64],
                      [64, 48], [0, 0]], np.int32)
    y, n1 = _counted(tile_kernel, lambda: net(x, sizes))
    ys, n = _counted(tile_kernel, lambda: sharded(x, sizes))
    assert n == 4 * n1 > 0  # every shard runs the whole program
    assert ys.device.type == "cuda" and ys.shape == y.shape
    assert _rel(ys, y) <= 1e-5
    assert not ys[7].any()


# ------------------------------------------- training: the flash backward

FLASH_BWD_REL = 5e-5  # the reference's gradient tolerance (test_flash_attention.py)


def _flash_operands(b, hq, hkv, sq, sk, hd, dev, seed):
    rng = np.random.default_rng(seed)
    mk = lambda shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
    return mk((b, hq, sq, hd)), mk((b, hkv, sk, hd)), mk((b, hkv, sk, hd)), mk((b, hq, sq, hd))


def _flash_bwd_check(q, k, v, do, causal, window):
    """Kernel forward (with lse) then kernel backward, against the plain
    backward fed the same o and lse: (max rel error over dq, dk, dv,
    launches of the backward, the kernel's (dq, dk, dv))."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    o, lse = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                               return_lse=True)
    grads, n = _counted(bwd_kernel, lambda: bwd_kernel.flash_attention_bwd_call(
        q, k, v, o, lse, do, causal=causal, window=window))
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
    return max(_rel(g, w) for g, w in zip(grads, want)), n, grads


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128, 256])
@pytest.mark.parametrize("hkv", [4, 1])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0)])
def test_cuda_flash_backward_matches_plain(cuda_device, hd, hkv, causal, window):
    """Every head dim, GQA g 1 and 4, causal with and without a window and
    non-causal, S 77 (ragged against the 32-row tiles): one launch, dq, dk
    and dv each within rel 5e-5 of the plain backward."""
    q, k, v, do = _flash_operands(2, 4, hkv, 77, 77, hd, cuda_device, seed=40 + hd)
    err, n, _ = _flash_bwd_check(q, k, v, do, causal, window)
    assert n == 1
    assert err < FLASH_BWD_REL


@pytest.mark.parametrize("name,shape", [
    ("gemma3-global-B4-S1024-hd256-g4", (4, 4, 1, 1024, 1024, 256, True, 0)),
    ("gemma3-local-w512-B4-S1024-hd256-g4", (4, 4, 1, 1024, 1024, 256, True, 512)),
    ("rows-that-see-no-key-Sq200-Sk50-w40", (1, 2, 1, 200, 50, 64, True, 40)),
    ("non-causal-Sq77-Sk256-hd128", (1, 2, 1, 77, 256, 128, False, 0)),
    ("moonshot-B4-H16-S1024-hd128", (4, 16, 16, 1024, 1024, 128, True, 0)),
])
def test_cuda_flash_backward_at_training_and_edge_shapes(cuda_device, name, shape):
    """gemma3-1b's and moonshot-v1-16b-a3b's training layers in the
    model's layout (transposed views), and rows that see no key (their dq
    must be exactly 0)."""
    b, hq, hkv, sq, sk, hd, causal, window = shape
    rng = np.random.default_rng(50)
    mk = lambda s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=cuda_device).transpose(1, 2)
    q, do = mk((b, sq, hq, hd)), mk((b, sq, hq, hd))
    k, v = mk((b, sk, hkv, hd)), mk((b, sk, hkv, hd))
    err, n, (dq, _, _) = _flash_bwd_check(q, k, v, do, causal, window)
    assert n == 1 and err < FLASH_BWD_REL, (name, err)
    if name.startswith("rows-that-see-no-key"):  # row i sees key j <= i only if i - j < 40
        assert dq[:, :, sk - 1 + window:].count_nonzero() == 0
        assert dq[:, :, :sk - 1 + window].count_nonzero() > 0


@pytest.mark.parametrize("hd", [80, 112, 256])
def test_cuda_flash_backward_long_non_causal(cuda_device, hd):
    """Sq = Sk = 1024 with no mask and g 4: the longest chain of every
    product (a dK item sums 4 heads x 1024 rows); dq, dk, dv each within
    rel 5e-5 of the plain backward, one wrapper call a call."""
    q, k, v, do = _flash_operands(2, 4, 1, 1024, 1024, hd, cuda_device, seed=90 + hd)
    err, n, _ = _flash_bwd_check(q, k, v, do, False, 0)
    assert n == 1 and err < FLASH_BWD_REL, err


SEAMLESS_BWD_REL = 1e-5  # the new shapes' gate


@pytest.mark.parametrize("name,shape", [
    ("seamless-cross-B4-H16-Sq512-Sk1024-hd64", (4, 16, 16, 512, 1024, 64, False)),
    ("seamless-encoder-B4-H16-S1024-hd64", (4, 16, 16, 1024, 1024, 64, False)),
    ("seamless-decoder-self-B4-H16-S512-hd64", (4, 16, 16, 512, 512, 64, True)),
])
def test_cuda_flash_backward_at_the_encoder_decoder_shapes(cuda_device, name, shape):
    """seamless-m4t-medium's training attention, MHA at hd 64 in the
    model's layout: the cross attention at Sq 512 / Sk 1024 and the
    encoder's self-attention at S 1024, where every (q tile, kv tile) pair
    is live, and the decoder's causal self-attention at S 512.  The work
    list must give each dK/dV and dQ block one owner: one launch, dq, dk,
    dv within rel 1e-5 of the plain backward, bitwise the same on a second
    run."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel

    b, hq, hkv, sq, sk, hd, causal = shape
    rng = np.random.default_rng(52)
    mk = lambda s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=cuda_device).transpose(1, 2)
    q, do = mk((b, sq, hq, hd)), mk((b, sq, hq, hd))
    k, v = mk((b, sk, hkv, hd)), mk((b, sk, hkv, hd))
    err, n, grads = _flash_bwd_check(q, k, v, do, causal, 0)
    assert n == 1 and err < SEAMLESS_BWD_REL, (name, err)
    items = bwd_kernel.work_list(b, hq, hkv, sq, sk, hd, causal, 0)
    assert len(items) == b * hkv * -(-sk // bwd_kernel.TILE) + b * hq * -(-sq // bwd_kernel.TILE)
    _, _, again = _flash_bwd_check(q, k, v, do, causal, 0)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


def test_cuda_flash_attention_function_at_non_causal_sq_other_than_sk(cuda_device):
    """Autograd through `FlashAttention` on the card at non-causal Sq 128 /
    Sk 256 (cross attention's case): one forward and one backward launch,
    the output and gradients within rel 1e-5 of the CPU's plain versions."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models.flash_attention import flash_attention as flash_grad

    q, _, _, do = _flash_operands(2, 16, 16, 128, 128, 64, cuda_device, seed=81)
    _, k, v, _ = _flash_operands(2, 16, 16, 256, 256, 64, cuda_device, seed=82)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_kernel.LAUNCHES, bwd_kernel.LAUNCHES
    o = flash_grad(*leaves, causal=False)
    o.backward(do)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES - f0 == 1 and bwd_kernel.LAUNCHES - b0 == 1
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    o_cpu = flash_grad(*cpu, causal=False)
    o_cpu.backward(do.cpu())
    assert _rel(o.detach().cpu(), o_cpu.detach()) < SEAMLESS_BWD_REL
    for t, c in zip(leaves, cpu):
        assert _rel(t.grad.cpu(), c.grad) < SEAMLESS_BWD_REL


def test_cuda_flash_backward_launches_delta_and_one_main_kernel(cuda_device):
    """A call launches two kernels: the delta pass and the main kernel,
    once each (the profiler's device events over four calls; it drops an
    event now and then, so a kernel may show one launch fewer)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    q, k, v, do = _flash_operands(2, 4, 1, 256, 256, 256, cuda_device, seed=95)
    o, lse = flash_kernel.flash_attention_call(q, k, v, causal=True, window=0, return_lse=True)
    run = lambda: bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=True, window=0)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            run()
            torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "flash_bwd" in e.key:
            kind = "delta" if "flash_bwd_delta_kernel" in e.key else "main"
            # the fp32 main kernel: the bf16 one is a source of its own
            assert kind == "delta" or "flash_bwd_kernel<256, 256>" in e.key, e.key
            counts[kind] = counts.get(kind, 0) + e.count
    assert set(counts) == {"delta", "main"}
    assert all(3 <= c <= 4 for c in counts.values()), counts


def test_cuda_flash_backward_is_bitwise_deterministic(cuda_device):
    """No atomics: two runs of the backward give the same bits."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    q, k, v, do = _flash_operands(2, 4, 1, 300, 300, 256, cuda_device, seed=60)
    o, lse = flash_kernel.flash_attention_call(q, k, v, causal=True, window=100,
                                               return_lse=True)
    a = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=True, window=100)
    b = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=True, window=100)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128, 256])
def test_cuda_flash_forward_output_is_bitwise_the_same_with_lse(cuda_device, hd):
    """Writing the log-sum-exp changes no bit of o, and lse is within rel
    1e-5 of the plain version's (0 for rows that see no key)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import lse_ref

    for causal, window, sq, sk in ((True, 0, 130, 130), (True, 24, 200, 50), (False, 0, 77, 96)):
        q, k, v, _ = _flash_operands(2, 4, 2, sq, sk, hd, cuda_device, seed=70 + hd)
        o = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window)
        o2, lse = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                                    return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(o, o2)
        want = lse_ref(q, k, causal=causal, window=window)
        assert float((lse - want).abs().max() / want.abs().max()) < 1e-5


def test_cuda_flash_attention_function_launches_forward_and_backward(cuda_device):
    """Autograd through `FlashAttention` on the card: one forward launch
    (with lse), one backward launch, gradients within rel 5e-5 of the
    plain backward on the CPU."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models.flash_attention import flash_attention as flash_grad

    q, k, v, do = _flash_operands(2, 4, 1, 150, 150, 256, cuda_device, seed=80)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_kernel.LAUNCHES, bwd_kernel.LAUNCHES
    o = flash_grad(*leaves, causal=True, window=64)
    o.backward(do)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES - f0 == 1 and bwd_kernel.LAUNCHES - b0 == 1
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    flash_grad(*cpu, causal=True, window=64).backward(do.cpu())
    for t, c in zip(leaves, cpu):
        assert _rel(t.grad.cpu(), c.grad) < FLASH_BWD_REL


def test_cuda_kernels_without_a_backward_refuse_grad(cuda_device):
    """The raw conv1d call, the decode MLP and the tile kernel raise under
    grad on the card instead of returning an output with no gradient; so
    does the flash forward called directly (training goes through
    `FlashAttention`).  `conv1d_fused` under grad returns a graph
    (`Conv1dFused`)."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused
    from repro_torch.kernels.conv1d_fused import kernel as conv_kernel
    from repro_torch.kernels.decode_mlp import decode_mlp
    from repro_torch.kernels.flash_attention import flash_attention

    dev = cuda_device
    x = torch.randn(2, 40, 64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="conv1d_fused_call.*Conv1dFused"):
        conv_kernel.conv1d_fused_call(x, torch.randn(4, 64, device=dev),
                                      torch.zeros(64, device=dev), activation="silu")
    y = conv1d_fused(x, torch.randn(4, 64, device=dev), torch.zeros(64, device=dev))
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "Conv1dFusedBackward"
    h = torch.randn(2, 64, device=dev, requires_grad=True)
    w = [torch.randn(*s, device=dev) for s in ((64, 96), (64, 96), (96, 64))]
    with pytest.raises(NotImplementedError, match="decode_mlp.*ROADMAP"):
        decode_mlp(h, *w)
    img = torch.randn(1, 20, 20, 4, requires_grad=True)
    wk = torch.randn(3, 3, 4, 8)
    with pytest.raises(NotImplementedError, match="fused_tile.*ROADMAP"):
        ft.conv2d_fused_tile(img, wk, transforms.WinogradTransform(m=3, k=3), pad=1,
                             device=dev)
    q = torch.randn(1, 2, 16, 16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        flash_attention(q, q, q)
    with torch.no_grad():  # the same calls without grad run
        conv1d_fused(x, torch.randn(4, 64, device=dev), torch.zeros(64, device=dev))
        decode_mlp(h, *w)


def test_cuda_lm_loss_gradients_match_the_cpu(cuda_device):
    """Reduced gemma3-1b: `lm_loss` and every gradient on the card (flash
    forward and backward kernels, remat) within rel 1e-3 of the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import init_lm, lm_loss

    cfg = get_arch("gemma3-1b").reduced()
    cpu = init_lm(cfg, seed=0, device="cpu")
    card = init_lm(cfg, seed=0, device="cpu").to(cuda_device)
    cpu.requires_grad_(True)
    card.requires_grad_(True)
    rng = np.random.default_rng(90)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    f0, b0 = flash_kernel.LAUNCHES, bwd_kernel.LAUNCHES
    loss_d, _ = lm_loss(card, {k: t.to(cuda_device) for k, t in batch.items()})
    loss_d.backward()
    torch.cuda.synchronize()
    n_layers = len(card.specs)
    assert flash_kernel.LAUNCHES - f0 == 2 * n_layers  # remat: forward twice
    assert bwd_kernel.LAUNCHES - b0 == n_layers
    loss_c, _ = lm_loss(cpu, batch)
    loss_c.backward()
    assert abs(float(loss_d.detach()) - float(loss_c.detach())) < 1e-4 * abs(float(loss_c.detach()))
    for (n, pd), (_, pc) in zip(card.named_parameters(), cpu.named_parameters()):
        assert _rel(pd.grad.cpu(), pc.grad) < 1e-3, n


def test_cuda_encoder_decoder_lm_loss_matches_the_cpu(cuda_device):
    """Reduced seamless-m4t-medium (2 encoder and 4 decoder layers), 40
    source frames and 30 target tokens: `lm_loss` and every gradient on
    the card within rel 1e-4 / 1e-3 of the CPU; the flash forward launches
    encoder + 2 x (self + cross) x decoder layers (remat), its backward
    encoder + 2 x decoder layers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import init_lm, lm_loss

    cfg = get_arch("seamless-m4t-medium").reduced()
    cpu = init_lm(cfg, seed=0, device="cpu")
    card = init_lm(cfg, seed=0, device="cpu").to(cuda_device)
    cpu.requires_grad_(True)
    card.requires_grad_(True)
    rng = np.random.default_rng(91)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 31)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "src_embeds": torch.tensor(
        rng.standard_normal((2, 40, cfg.d_model)), dtype=torch.float32)}
    f0, b0 = flash_kernel.LAUNCHES, bwd_kernel.LAUNCHES
    loss_d, _ = lm_loss(card, {k: t.to(cuda_device) for k, t in batch.items()})
    loss_d.backward()
    torch.cuda.synchronize()
    n_enc, n_dec = len(card.enc_specs), len(card.specs)
    assert flash_kernel.LAUNCHES - f0 == n_enc + 2 * 2 * n_dec
    assert bwd_kernel.LAUNCHES - b0 == n_enc + 2 * n_dec
    loss_c, _ = lm_loss(cpu, batch)
    loss_c.backward()
    assert abs(float(loss_d.detach()) - float(loss_c.detach())) < 1e-4 * abs(float(loss_c.detach()))
    for (n, pd), (_, pc) in zip(card.named_parameters(), cpu.named_parameters()):
        assert _rel(pd.grad.cpu(), pc.grad) < 1e-3, n


def _moe_case(cuda_device):
    """moonshot's MoE at 64 experts, top-6, with d 256 and d_ff 128, at
    capacity factor 0.5, weights from the port's initialiser (seed 0):
    one CPU copy and one card copy, and a (2, 200, 256) batch whose
    first 150 rows are one pad row (right-aligned prompts of 200 and 50)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import Params

    cfg = get_arch("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(cfg, d_model=256, d_ff=128, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = Params(moe_mod.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu"))
    x = torch.tensor(np.random.default_rng(60).standard_normal((2, 200, 256)),
                     dtype=torch.float32)
    x[1, :150] = x[0, 0]
    return cfg, p, x


def test_cuda_moe_forward_matches_the_cpu_where_capacity_drops(cuda_device):
    """`moe_forward` on the card against the CPU at a capacity that drops
    pairs (the pad rows fill their experts): the same top-6 sets and kept
    (token, expert) pairs, output and aux losses within rel 1e-5; with
    the card in sync-debug mode "error" (no host sync in the layer), and
    bitwise the same output twice."""
    import copy

    from repro_torch.models import moe as moe_mod

    cfg, p, x = _moe_case(cuda_device)
    with moe_mod.record_routing() as routes:
        ref, ref_aux = moe_mod.moe_forward(p, x, cfg)
        pd, xd = copy.deepcopy(p).to(cuda_device), x.to(cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_mod.moe_forward(pd, xd, cfg)
            again, _ = moe_mod.moe_forward(pd, xd, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    cpu, card = routes[0], routes[1]
    assert int((~cpu.keep).sum()) > 0  # capacity dropped pairs
    assert torch.equal(card.ids.cpu().sort(dim=1).values, cpu.ids.sort(dim=1).values)
    assert torch.equal(card.keep.cpu(), cpu.keep) and torch.equal(card.slot.cpu(), cpu.slot)
    assert _rel(y.cpu(), ref) < 1e-5
    for k in ("moe_aux", "moe_z"):
        assert abs(float(aux[k]) - float(ref_aux[k])) <= 1e-5 * abs(float(ref_aux[k])), k
    assert torch.equal(y, again)


def test_cuda_moonshot_lm_loss_matches_the_cpu(cuda_device):
    """Reduced moonshot-v1-16b-a3b: `lm_loss`, its aux losses and every
    gradient (routers included) on the card within rel 1e-4 / 1e-3 of
    the CPU; flash launched twice a layer (remat) and its backward once."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import init_lm, lm_loss

    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    cpu = init_lm(cfg, seed=0, device="cpu")
    card = init_lm(cfg, seed=0, device="cpu").to(cuda_device)
    cpu.requires_grad_(True)
    card.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(91).integers(0, cfg.vocab_size, (2, 41)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    f0, b0 = flash_kernel.LAUNCHES, bwd_kernel.LAUNCHES
    loss_d, m_d = lm_loss(card, {k: t.to(cuda_device) for k, t in batch.items()})
    loss_d.backward()
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES - f0 == 2 * cfg.n_layers
    assert bwd_kernel.LAUNCHES - b0 == cfg.n_layers
    loss_c, m_c = lm_loss(cpu, batch)
    loss_c.backward()
    for k in ("loss", "moe_aux", "moe_z"):
        want = float(m_c[k].detach())
        assert want != 0 and abs(float(m_d[k].detach()) - want) < 1e-4 * abs(want), k
    for (n, pd), (_, pc) in zip(card.named_parameters(), cpu.named_parameters()):
        assert _rel(pd.grad.cpu(), pc.grad) < 1e-3, n


# ------------------------------------------------------------ bf16
#
# The bf16 instantiations against their plain versions on the same bf16
# inputs, and both against float64 from those inputs: the kernel's max
# error at most twice the plain version's plus one bf16 ulp of max |out|
# (the output is rounded to bf16 once on both sides; the kernel sums in
# another order), and bitwise the same twice.

BF16 = torch.bfloat16


def _bf16_operand(rng, shape, dev, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(dev, BF16)


def _bf16_rule(run, plain, f64):
    y1, y2, ref, exact = run(), run(), plain(), f64()
    torch.cuda.synchronize()
    assert y1.dtype == BF16 and y1.shape == ref.shape == exact.shape
    assert torch.isfinite(y1.float()).all()
    ulp = 2.0 ** (np.floor(np.log2(float(exact.abs().max()))) - 7)
    err_k = float((y1.double() - exact).abs().max())
    err_p = float((ref.double() - exact).abs().max())
    assert err_k <= 2 * err_p + ulp, (err_k, err_p, ulp)
    assert torch.equal(y1, y2)


def _f64_attention(q, k, v, causal, window):
    g = q.shape[1] // k.shape[1]
    k, v = k.double().repeat_interleave(g, 1), v.double().repeat_interleave(g, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k) * q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    qp, kp = torch.arange(sq, device=q.device)[:, None], torch.arange(sk, device=q.device)[None]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= qp - kp < window
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~ok, float("-inf")), -1), nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


BF16_FLASH_SHAPES = {
    # name: (B, Hq, Hkv, Sq, Sk, causal, window, model layout); every
    # instantiated (hd, vd) runs each
    "g4-causal-S300": (2, 4, 1, 300, 300, True, 0, True),
    "g2-window64-S200": (1, 4, 2, 200, 200, True, 64, False),
    "noncausal-Sq77-Sk256": (1, 2, 2, 77, 256, False, 0, False),
    "masked-rows-Sq200-Sk50-w40": (1, 4, 4, 200, 50, True, 40, True),
    "cross-decode-Sq1-Sk1024": (2, 4, 4, 1, 1024, False, 0, True),
}


@pytest.mark.parametrize("name", sorted(BF16_FLASH_SHAPES))
def test_cuda_flash_bf16_at_every_head_dim(cuda_device, name):
    from repro_torch.kernels.flash_attention import attention_ref, flash_forward
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    b, hq, hkv, sq, sk, causal, window, layout = BF16_FLASH_SHAPES[name]
    rng = np.random.default_rng(31)
    for hd, vd in flash_kernel.HEAD_DIMS:
        if layout:
            q = _bf16_operand(rng, (b, sq, hq, hd), cuda_device).transpose(1, 2)
            k = _bf16_operand(rng, (b, sk, hkv, hd), cuda_device).transpose(1, 2)
            v = _bf16_operand(rng, (b, sk, hkv, vd), cuda_device).transpose(1, 2)
        else:
            q = _bf16_operand(rng, (b, hq, sq, hd), cuda_device)
            k = _bf16_operand(rng, (b, hkv, sk, hd), cuda_device)
            v = _bf16_operand(rng, (b, hkv, sk, vd), cuda_device)
        _, n = _counted(flash_kernel, lambda: flash_forward(q, k, v, causal=causal, window=window))
        assert n == 1
        _bf16_rule(lambda: flash_forward(q, k, v, causal=causal, window=window),
                   lambda: attention_ref(q, k, v, causal=causal, window=window),
                   lambda: _f64_attention(q, k, v, causal, window))


@pytest.mark.parametrize("b,d,f", [(4, 1152, 6912), (1, 1152, 6912), (2, 3584, 14336),
                                   (1, 1024, 4096), (11, 200, 704)])
def test_cuda_decode_mlp_bf16(cuda_device, b, d, f):
    from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref
    from repro_torch.kernels.decode_mlp import kernel as mlp_kernel

    rng = np.random.default_rng(32)
    x = _bf16_operand(rng, (b, d), cuda_device)
    w1, w3 = (_bf16_operand(rng, (d, f), cuda_device, d ** -0.5) for _ in range(2))
    w2 = _bf16_operand(rng, (f, d), cuda_device, f ** -0.5)

    def f64():
        x64 = x.double()
        h = torch.nn.functional.silu(x64 @ w1.double()) * (x64 @ w3.double())
        return h @ w2.double()

    _, n = _counted(mlp_kernel, lambda: decode_mlp(x, w1, w3, w2))
    assert n == 1
    _bf16_rule(lambda: decode_mlp(x, w1, w3, w2), lambda: decode_mlp_ref(x, w1, w3, w2), f64)


# the bf16 conv1d forward: (B, L, D, K, row stride, column, activation) --
# the TMA stream at the served waves, the training slice, every K at a
# ragged length and L 1; PR 25's kernel for an unaligned slice and K 9
CONV1D_BF16 = {
    "mamba2-wave1": (4, 768, 4352, 4, 8512, 4096, "silu"),
    "zamba2-wave1": (4, 768, 7296, 4, 14576, 7168, "silu"),
    "unaligned-D71": (2, 300, 71, 4, 200, 65, "silu"),  # one channel a thread
    "K9-none": (2, 300, 256, 9, 256, 0, "none"),  # the any-K instance
    "mamba2-wave2": (2, 129, 4352, 4, 8512, 4096, "silu"),
    "mamba2-train": (4, 1024, 4352, 4, 8512, 4096, "silu"),
    "L1": (1, 1, 48, 4, 64, 8, "silu"),
    **{f"K{k}-L301-{act}": (2, 301, 512, k, 1024, 256, act)
       for k in range(1, 9) for act in ("silu", "none")},
}


@pytest.mark.parametrize("name", list(CONV1D_BF16))
def test_cuda_conv1d_bf16(cuda_device, name):
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

    b, length, d, k, row, off, act = CONV1D_BF16[name]
    rng = np.random.default_rng(33)
    x = _bf16_operand(rng, (b, length, row), cuda_device)[..., off:off + d]
    w = _bf16_operand(rng, (k, d), cuda_device, 0.5)
    bias = _bf16_operand(rng, (d,), cuda_device, 0.1)

    def f64():
        xp = torch.nn.functional.pad(x.double(), (0, 0, k - 1, 0))
        acc = sum(xp[:, i:i + length] * w[i].double() for i in range(k)) + bias.double()
        return torch.nn.functional.silu(acc) if act == "silu" else acc

    _, n = _counted(conv1d_kernel, lambda: conv1d_fused(x, w, bias, activation=act))
    assert n == 1
    _bf16_rule(lambda: conv1d_fused(x, w, bias, activation=act),
               lambda: conv1d_ref(x, w, bias, activation=act), f64)


@pytest.mark.parametrize("name", ["mamba2-wave1", "mamba2-wave2", "mamba2-train", "L1",
                                  "K1-L301-none", "K3-L301-silu", "K8-L301-silu"])
def test_cuda_conv1d_bf16_stream_is_bitwise_the_kept_kernel(cuda_device, name):
    """At an aligned shape the wrapper launches the TMA stream; PR 25's
    kernel, the route kept for every other bf16 shape, launched through
    its own entry at the same shape gives the same bits."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel

    b, length, d, k, row, off, act = CONV1D_BF16[name]
    rng = np.random.default_rng(34)
    x = _bf16_operand(rng, (b, length, row), cuda_device)[..., off:off + d]
    w = _bf16_operand(rng, (k, d), cuda_device, 0.5)
    bias = _bf16_operand(rng, (d,), cuda_device, 0.1)
    assert conv1d_kernel.takes_stream(d, row, k, x.data_ptr() % 16 == 0)
    y = conv1d_fused(x, w, bias, activation=act)
    kept = torch.empty_like(y)
    ptrs = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), kept.data_ptr())
    _, args = conv1d_kernel._launch_args(b, length, d, row, k, act == "silu",
                                         not any(p % 16 for p in ptrs), torch.bfloat16)
    conv1d_kernel.LIB.launch(conv1d_kernel.ENTRY[torch.bfloat16], x.device, *ptrs, args)
    torch.cuda.synchronize()
    assert torch.equal(y, kept)


def _f64_attention_grads(q, k, v, do, causal, window):
    """dq, dk, dv of attention in float64 from the (bf16) inputs."""
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    o = _f64_attention(*leaves, causal, window)
    return torch.autograd.grad(o, leaves, do.double())


def _bf16_grad_rule(run, plain, f64):
    """`_bf16_rule` for a tuple of gradients: each one's error against
    float64 at most twice the plain version's plus one bf16 ulp of its max,
    each bitwise the same twice."""
    g1, g2, ref, exact = run(), run(), plain(), f64()
    torch.cuda.synchronize()
    for a, b, p, e in zip(g1, g2, ref, exact):
        assert a.dtype == BF16 and a.shape == p.shape == e.shape
        assert torch.isfinite(a.float()).all()
        ulp = 2.0 ** (np.floor(np.log2(float(e.abs().max()))) - 7)
        err_k = float((a.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= 2 * err_p + ulp, (err_k, err_p, ulp)
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [
    (2, 4, 1, 300, 300, 256, 256, True, 100),  # gemma3's GQA 4:1, a window
    (1, 4, 4, 200, 200, 192, 128, True, 0),  # MLA
    (1, 4, 2, 150, 150, 56, 56, True, 0),  # the MTP block's padded 56
    (2, 4, 4, 77, 256, 64, 64, False, 0),  # cross attention, Sq != Sk
], ids=["hd256-g4-w100", "mla-192-128", "mtp-56", "cross-sq77-sk256"])
def test_cuda_bf16_gradients_match_their_plain_versions(cuda_device, shape):
    """Training in bf16: under grad a bf16 input reaches `FlashAttention`
    and the bf16 backward kernel (one launch of each a call), whose dq, dk,
    dv pass the bf16 rule against the plain backward fed the same o and
    lse, and against float64."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models.flash_attention import flash_attention

    b, hq, hkv, sq, sk, hd, vd, causal, window = shape
    rng = np.random.default_rng(34)
    q = _bf16_operand(rng, (b, hq, sq, hd), cuda_device).requires_grad_()
    k = _bf16_operand(rng, (b, hkv, sk, hd), cuda_device).requires_grad_()
    v = _bf16_operand(rng, (b, hkv, sk, vd), cuda_device).requires_grad_()
    do = _bf16_operand(rng, (b, hq, sq, vd), cuda_device)
    f0, b0 = flash_kernel.LAUNCHES, bwd_kernel.LAUNCHES
    o = flash_attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert (flash_kernel.LAUNCHES - f0, bwd_kernel.LAUNCHES - b0) == (1, 1)
    assert all(g.dtype == BF16 for g in grads)
    kw = dict(causal=causal, window=window)
    qd, kd, vd_ = q.detach(), k.detach(), v.detach()
    o2, lse = flash_kernel.flash_attention_call(qd, kd, vd_, return_lse=True, **kw)
    assert torch.equal(o2, o.detach())
    _bf16_grad_rule(
        lambda: bwd_kernel.flash_attention_bwd_call(qd, kd, vd_, o2, lse, do, **kw),
        lambda: flash_attention_bwd_ref(qd, kd, vd_, o2, lse, do, **kw),
        lambda: _f64_attention_grads(qd, kd, vd_, do, causal, window))
    again = torch.autograd.grad(flash_attention(q, k, v, causal=causal, window=window),
                                (q, k, v), do)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("route", ["streamed", "padded", "any-k"])
def test_cuda_bf16_conv1d_gradient_matches_its_plain_version(cuda_device, route):
    """Under grad a bf16 input reaches `Conv1dFused` and the bf16 backward
    entry (one launch a call): dx (read in the slice of the wide
    activation's gradient), dw and db pass the bf16 rule on each route of
    the bf16 source -- the streamed kernel on an aligned slice, the same
    kernel on zero-padded copies of a slice at an odd column, the segment-walk
    kernel at K 9 -- and equal the direct call's bits."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv1d_fused import backward as conv_backward
    from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref, conv1d_fused

    col, d, k = {"streamed": (16, 64, 4), "padded": (13, 70, 4), "any-k": (16, 64, 9)}[route]
    rng = np.random.default_rng(36)
    wide_x = _bf16_operand(rng, (2, 257, 96), cuda_device).requires_grad_()
    w = _bf16_operand(rng, (k, d), cuda_device, 0.5).requires_grad_()
    bias = _bf16_operand(rng, (d,), cuda_device, 0.1).requires_grad_()
    g = _bf16_operand(rng, (2, 257, d), cuda_device)
    b0 = conv_backward.LAUNCHES
    y = conv1d_fused(wide_x[..., col:col + d], w, bias)
    dwide, dw, db = torch.autograd.grad(y, (wide_x, w, bias), g)
    assert conv_backward.LAUNCHES - b0 == 1
    assert dwide.dtype == dw.dtype == db.dtype == BF16
    assert not dwide[..., :col].any() and not dwide[..., col + d:].any()
    x = wide_x.detach()[..., col:col + d]
    wd, bd = w.detach(), bias.detach()

    def f64():
        x64, w64, b64 = (t.double().requires_grad_(True) for t in (x, wd, bd))
        xp = F.pad(x64, (0, 0, k - 1, 0))
        out = F.silu(sum(xp[:, i:i + x.shape[1]] * w64[i] for i in range(k)) + b64)
        return torch.autograd.grad(out, (x64, w64, b64), g.double())

    run = lambda: conv_backward.conv1d_fused_bwd_call(x, wd, bd, g, activation="silu")
    _bf16_grad_rule(run, lambda: conv1d_bwd_ref(g, x, wd, bd), f64)
    assert all(torch.equal(a, b) for a, b in zip(
        run(), (dwide[..., col:col + d].contiguous(), dw, db)))


# the bf16 conv1d backward's stream (`conv1d_fused_bwd_bf16.cu`): (B, L, row
# stride, column, D, K) -- the training slices, L off the 16-row chunks,
# B 3, x at a row stride, and K 9 / 16 on the segment-walk kernel
CONV_BWD_BF16_SHAPES = {
    "mamba2-train": (4, 1024, 8512, 4096, 4352, 4),
    "zamba2-train": (4, 1024, 14576, 7168, 7296, 4),
    "B3-L777-strided": (3, 777, 1024, 256, 512, 4),
    "B2-L5": (2, 5, 64, 0, 64, 3),
    "B1-L1": (1, 1, 64, 8, 48, 2),
    "K9": (2, 300, 256, 0, 256, 9),
    "K16-strided": (2, 130, 512, 128, 256, 16),
}


def _conv_bwd_bf16_check(cuda_device, b, length, row, col, d, k, seed):
    import torch.nn.functional as F

    from repro_torch.kernels.conv1d_fused import backward as conv_backward
    from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref

    rng = np.random.default_rng(seed)
    x = _bf16_operand(rng, (b, length, row), cuda_device)[..., col:col + d]
    w = _bf16_operand(rng, (k, d), cuda_device, 0.5)
    bias = _bf16_operand(rng, (d,), cuda_device, 0.1)
    g = _bf16_operand(rng, (b, length, d), cuda_device)

    def f64():
        x64, w64, b64 = (t.double().requires_grad_(True) for t in (x, w, bias))
        xp = F.pad(x64, (0, 0, k - 1, 0))
        y = F.silu(sum(xp[:, i:i + length] * w64[i] for i in range(k)) + b64)
        return torch.autograd.grad(y, (x64, w64, b64), g.double())

    run = lambda: conv_backward.conv1d_fused_bwd_call(x, w, bias, g, activation="silu")
    _, n = _counted(conv_backward, run)
    assert n == 1
    _bf16_grad_rule(run, lambda: conv1d_bwd_ref(g, x, w, bias), f64)


@pytest.mark.parametrize("name", sorted(CONV_BWD_BF16_SHAPES))
def test_cuda_conv1d_bwd_bf16_stream_at_served_and_ragged_shapes(cuda_device, name):
    """dx, dw, db within the bf16 rule against float64, bitwise the same
    twice, one launch a call."""
    _conv_bwd_bf16_check(cuda_device, *CONV_BWD_BF16_SHAPES[name], seed=40)


@pytest.mark.parametrize("k", range(1, 9))
def test_cuda_conv1d_bwd_bf16_stream_at_every_tap_count(cuda_device, k):
    """Every K the streamed kernel instantiates, at a length off the
    chunks and x at a row stride."""
    _conv_bwd_bf16_check(cuda_device, 2, 301, 1024, 256, 512, k, seed=41)


def test_cuda_bf16_flash_backward_is_bitwise_over_two_calls(cuda_device):
    """The bf16 backward twice on the same inputs, bitwise, at MLA's (192,
    128) and at cross attention's Sq != Sk (no atomics; a fixed order)."""
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    rng = np.random.default_rng(37)
    for b, hq, sq, sk, hd, vd, causal in ((2, 8, 333, 333, 192, 128, True),
                                          (2, 4, 100, 1000, 64, 64, False)):
        q = _bf16_operand(rng, (b, hq, sq, hd), cuda_device)
        k = _bf16_operand(rng, (b, hq, sk, hd), cuda_device)
        v = _bf16_operand(rng, (b, hq, sk, vd), cuda_device)
        do = _bf16_operand(rng, (b, hq, sq, vd), cuda_device)
        o, lse = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=0,
                                                   return_lse=True)
        one = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=causal, window=0)
        two = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=causal, window=0)
        assert all(torch.equal(a, c) for a, c in zip(one, two))


# the bf16 kernels' 64-row warpgroup tiles at their edges: Sq and Sk of 1,
# 63, 65, 127 and 129, causal, windows whose rows see no key, at the head
# dims that fill a 64-column atom in part (56, 80, 112), GQA g 1, 4 and 8
BF16_TILE_EDGES = {
    "Sq1-Sk1": (1, 1, False, 0),
    "Sq63-Sk65-causal": (63, 65, True, 0),
    "Sq65-Sk63-causal": (65, 63, True, 0),
    "Sq127-Sk129": (127, 129, False, 0),
    "Sq129-Sk127-causal": (129, 127, True, 0),
    "Sq129-Sk63-w24-no-key-rows": (129, 63, True, 24),
    "Sq65-Sk129-w70": (65, 129, True, 70),
}


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("hd", [56, 80, 112])
@pytest.mark.parametrize("name", sorted(BF16_TILE_EDGES))
def test_cuda_bf16_flash_tile_edges(cuda_device, name, hd, g):
    """The bf16 forward and backward at the warpgroup tiles' edges: each
    output within the bf16 rule against float64 (rows that see no key
    exactly 0), and bitwise the same twice."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    sq, sk, causal, window = BF16_TILE_EDGES[name]
    b, hkv = 2, 2
    hq = hkv * g
    rng = np.random.default_rng(41)
    q = _bf16_operand(rng, (b, sq, hq, hd), cuda_device).transpose(1, 2)
    k = _bf16_operand(rng, (b, sk, hkv, hd), cuda_device).transpose(1, 2)
    v = _bf16_operand(rng, (b, sk, hkv, hd), cuda_device).transpose(1, 2)
    do = _bf16_operand(rng, (b, sq, hq, hd), cuda_device).transpose(1, 2)
    kw = dict(causal=causal, window=window)
    _bf16_rule(lambda: flash_kernel.flash_attention_call(q, k, v, **kw),
               lambda: attention_ref(q, k, v, **kw),
               lambda: _f64_attention(q, k, v, causal, window))
    o, lse = flash_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
    unseen = torch.arange(sq, device=cuda_device) - window + 1 >= sk if window else None
    if unseen is not None and unseen.any():
        assert (o[:, :, unseen] == 0).all() and (lse[:, :, unseen] == 0).all()
    run = lambda: bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, **kw)
    plain = lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    exact = lambda: _f64_attention_grads(q, k, v, do, causal, window)
    if sk > 1:
        _bf16_grad_rule(run, plain, exact)
        return
    # one key: P = 1 and dS = dP - delta = 0 up to f32 rounding of the two
    # sums, so dQ and dK are zero up to it (the relative rule has no scale
    # there); dV = sum of dO over the rows is held to the rule
    dq, dk, dv = run()
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), run()))
    assert float(dq.abs().max()) < 1e-5 and float(dk.abs().max()) < 1e-5
    _bf16_grad_rule(lambda: run()[2:], lambda: plain()[2:], lambda: exact()[2:])


def test_cuda_float16_under_grad_still_raises(cuda_device):
    """The backward kernels take fp32 and bf16: a float16 input under grad
    raises on the card, before any launch; serving's kernels refuse it
    too."""
    from repro_torch.kernels.conv1d_fused import conv1d_fused
    from repro_torch.models.flash_attention import flash_attention

    rng = np.random.default_rng(38)
    q, k, v = (_bf16_operand(rng, (1, 4, 32, 64), cuda_device).half().requires_grad_()
               for _ in range(3))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        flash_attention(q, k, v, causal=True)
    x = _bf16_operand(rng, (2, 40, 64), cuda_device).half().requires_grad_()
    w, bias = (_bf16_operand(rng, s, cuda_device).half() for s in ((4, 64), (64,)))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        conv1d_fused(x, w, bias)


def test_cuda_bf16_kernels_refuse_what_they_do_not_take(cuda_device):
    """Mixed dtypes, and a bf16 decode MLP whose widths are not multiples
    of its 8-value units, raise before any launch."""
    from repro_torch.kernels.decode_mlp import decode_mlp
    from repro_torch.kernels.flash_attention import flash_forward

    rng = np.random.default_rng(35)
    q = _bf16_operand(rng, (1, 2, 16, 64), cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_forward(q, q.float(), q, causal=True)
    with pytest.raises(ValueError):
        flash_forward(q.half(), q.half(), q.half(), causal=True)
    x = _bf16_operand(rng, (2, 64), cuda_device)
    w1, w3 = _bf16_operand(rng, (64, 33), cuda_device), _bf16_operand(rng, (64, 33), cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        decode_mlp(x, w1, w3, _bf16_operand(rng, (33, 64), cuda_device))


# ------------------------------------------- a second card in one process


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: what a second card of one process launches")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0"), torch.device("cuda:1")


def _on_card_tile(dev):
    tr, b, h, w, c_in, c_out, groups, bias_relu = SERVED["vgg-64to64-at64"]  # 71,616 B
    x, wk, ep = _served_operands(tr, b, h, w, c_in, c_out, groups, bias_relu, dev, seed=6)
    spec = tr.kernel_spec()
    plan = tiling.TilePlan.build(h, w, tr.k, 1, tr.t)
    ref = ft.matrix_tile_conv(tiling.pad_input(x, plan), spec.pack_rhs(tr.kernel_transform(wk), 1),
                              plan, spec, groups=1, epilogue=ep)
    return (ft.conv2d_fused_tile(x, wk, tr, pad=1, device=dev),), (ref,), 1e-5


def _on_card_conv1d(dtype, backward=False):
    def run(dev):
        from repro_torch.kernels.conv1d_fused import (
            backward as conv_backward, conv1d_bwd_ref, conv1d_fused, conv1d_ref)

        rng = np.random.default_rng(50)
        mk = lambda shape, s=1.0: torch.tensor(  # noqa: E731
            rng.standard_normal(shape) * s, dtype=torch.float32).to(dev, dtype)
        x = mk((4, 768, 8512))[..., 4096:4096 + 4352]  # mamba2's first prefill wave
        w, b, g = mk((4, 4352), 0.5), mk((4352,), 0.1), mk((4, 768, 4352))
        if backward:
            got = conv_backward.conv1d_fused_bwd_call(x, w, b, g, activation="silu")
            return got, conv1d_bwd_ref(g, x, w, b), 2e-2
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        return (conv1d_fused(x, w, b),), (conv1d_ref(x, w, b),), tol
    return run


def _on_card_flash(dtype, backward=False):
    def run(dev):
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_bwd_ref, flash_forward)
        from repro_torch.kernels.flash_attention import backward as bwd_kernel
        from repro_torch.kernels.flash_attention import kernel as flash_kernel

        rng = np.random.default_rng(51)
        mk = lambda shape: torch.tensor(  # noqa: E731
            rng.standard_normal(shape), dtype=torch.float32).to(dev, dtype)
        q, k, v, do = mk((1, 4, 700, 256)), mk((1, 1, 700, 256)), mk((1, 1, 700, 256)), mk(
            (1, 4, 700, 256))  # gemma3-1b's global layer, hd 256
        if not backward:
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            return (flash_forward(q, k, v),), (attention_ref(q, k, v),), tol
        o, lse = flash_kernel.flash_attention_call(q, k, v, causal=True, window=0,
                                                   return_lse=True)
        got = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, causal=True, window=0)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=0)
        return got, want, (FLASH_BWD_REL if dtype == torch.float32 else 2e-2)
    return run


def _on_card_mlp(dtype):
    def run(dev):
        from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref

        rng = np.random.default_rng(52)
        mk = lambda shape, s: torch.tensor(  # noqa: E731
            rng.standard_normal(shape) * s, dtype=torch.float32).to(dev, dtype)
        x, w1, w3, w2 = (mk((4, 1152), 1.0), mk((1152, 6912), 1152 ** -0.5),
                         mk((1152, 6912), 1152 ** -0.5), mk((6912, 1152), 6912 ** -0.5))
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        return (decode_mlp(x, w1, w3, w2),), (decode_mlp_ref(x, w1, w3, w2),), tol
    return run


# every kernel source at a shape whose block asks for more than 48 KB of
# shared memory (the fp32 conv1d asks for none; it runs for its launch)
ON_A_SECOND_CARD = {
    "fused_tile": (_on_card_tile, "fused_tile"),
    "conv1d_fused": (_on_card_conv1d(torch.float32), "conv1d_fused"),
    "conv1d_fused_fwd_bf16": (_on_card_conv1d(BF16), "conv1d_fused_fwd_bf16"),
    "conv1d_fused_bwd_bf16": (_on_card_conv1d(BF16, backward=True), "conv1d_fused_bwd_bf16"),
    "flash_attention": (_on_card_flash(torch.float32), "flash_attention"),
    "flash_attention_bf16": (_on_card_flash(BF16), "flash_attention_bf16"),
    "flash_attention_bwd": (_on_card_flash(torch.float32, backward=True), "flash_attention_bwd"),
    "flash_attention_bwd_bf16": (_on_card_flash(BF16, backward=True),
                                 "flash_attention_bwd_bf16"),
    "decode_mlp": (_on_card_mlp(torch.float32), "decode_mlp"),
    "decode_mlp_bf16": (_on_card_mlp(BF16), "decode_mlp"),
}


@pytest.mark.parametrize("name", list(ON_A_SECOND_CARD))
def test_cuda_every_kernel_launches_on_cuda1_after_cuda0(two_cards, name):
    """The shared-memory opt-in holds per card: after a launch on cuda:0
    the same kernel launches on cuda:1 (counted there), each card's
    output matches its plain version, and cuda:1's is bitwise cuda:0's."""
    from repro_torch.kernels import _build

    run, stem = ON_A_SECOND_CARD[name]
    outs = []
    for dev in two_cards:
        before = _build.CARD_LAUNCHES.get((stem, dev.index), 0)
        got, want, tol = run(dev)
        torch.cuda.synchronize(dev)
        assert _build.CARD_LAUNCHES.get((stem, dev.index), 0) > before, dev
        for g, w in zip(got, want):
            assert g.device == dev and g.shape == w.shape
            assert _rel(g.float(), w.float()) < tol, (dev, _rel(g.float(), w.float()))
        outs.append([g.cpu() for g in got])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_cuda_replica_pool_worker_serves_two_cards_on_their_streams(two_cards):
    """One `ReplicaPool` worker thread serves a vgg replica on cuda:0 and
    one on cuda:1 (one engine a card, one shared cache): it keeps a stream
    on each card, so each wave waits on its own card's stream, and every
    output is bitwise the one cuda:0's replica gives running the waves
    serially."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, KernelCache, init_weights
    from repro_torch.convserve.runtime import (
        ReplicaPool, Request, RuntimeConfig, WaveScheduler, make_images, poisson_trace,
    )
    from repro_torch.core import analysis

    spec, ws = vgg_mixed_channel(3), init_weights(vgg_mixed_channel(3), seed=0)
    cache = KernelCache()
    nets = []
    for dev in two_cards:
        engine = Engine(hw=analysis.H100_SXM, device=dev, cache=cache)
        plan = nets[0].plan if nets else None
        nets.append(engine.compile(spec, ws, input_hw=(64, 64), plan=plan, fuse=None)
                    if plan else engine.compile(spec, ws, input_hw=(64, 64)))
    pool = ReplicaPool(nets, workers=1)
    pool.warmup((32, 64), (4,))
    trace = poisson_trace(40.0, 24, seed=7, sizes=(32, 48, 64))
    images = make_images(trace, 3, seed=8)
    sched = WaveScheduler(spec, RuntimeConfig(max_batch=4, buckets=(32, 64), queue_depth=64))
    for a in trace:
        assert sched.admit(Request(rid=a.rid, image=images[a.rid]), now=0.0) is None
    waves = []
    while (w := sched.drain_wave()) is not None:
        waves.append(w)
    results = [f.result() for f in [pool.submit(w) for w in waves]]
    assert [d > 0 for d in pool.stats()["dispatched"]] == [True, True]
    assert {r.replica for r in results} == {0, 1}
    for w, res in zip(waves, results):
        serial = w.crop(spec, nets[0](*w.assemble()).cpu().numpy())
        for rid, y in serial.items():
            assert np.array_equal(res.outputs[rid], y), rid
    pool.shutdown()


def test_cuda_sharded_vgg_wave_over_two_cards(two_cards):
    """A ragged vgg wave of 8 on a data mesh of cuda:0 and cuda:1: the
    mesh path (counted), a shard a card, each on a stream of its card (the
    tile kernel launched on both), within rel 1e-5 of the unsharded wave and
    on cuda:0; SHARD placement keeps half of each stack on each card,
    gathers the other half at every read and leaves the output bitwise."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.convserve.fleet import (
        ShardedWaveExecutor, apply_placement, plan_weight_placement)
    from repro_torch.core import analysis
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import _build

    spec, ws = vgg_mixed_channel(3), init_weights(vgg_mixed_channel(3), seed=0)
    engine = Engine(hw=analysis.H100_SXM, device=two_cards[0])
    net = engine.compile(spec, ws, input_hw=(64, 64))
    mesh = Mesh({"data": 2}, devices=list(two_cards))
    sh = ShardedWaveExecutor(engine.compile(spec, ws, plan=net.plan, input_hw=(64, 64)),
                             shards=2, mesh=mesh)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((8, 64, 64, 3)) * 0.1).astype(np.float32)
    sizes = np.array([[64, 64], [48, 48], [64, 64], [32, 32], [48, 48], [64, 64],
                      [64, 48], [0, 0]], np.int32)
    y = net(x, sizes)
    before = _build.CARD_LAUNCHES.get(("fused_tile", 1), 0)
    ys = sh(x, sizes)
    torch.cuda.synchronize()
    assert sh.stats()["sharded_waves"]["mesh"] == 1
    assert _build.CARD_LAUNCHES.get(("fused_tile", 1), 0) > before
    assert ys.device == y.device and ys.shape == y.shape
    assert _rel(ys, y) <= 1e-5 and not ys[7].any()
    counts = apply_placement(net, mesh, plan_weight_placement(net, threshold_bytes=1))
    assert counts["sharded"] >= 1
    stats = engine.cache.placement_stats()
    assert stats["resident_bytes"]["cuda:0"] == stats["resident_bytes"]["cuda:1"] > 0
    placed = sh(x, sizes)
    torch.cuda.synchronize()
    assert torch.equal(placed, ys)
    assert engine.cache.placement_stats()["gathers"] > stats["gathers"]
