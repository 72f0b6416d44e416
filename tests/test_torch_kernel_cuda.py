"""The CUDA tile kernel on the card, against its plain PyTorch version.

Skips on a host without a CUDA card (the kernel has no CPU mode).  It
imports neither JAX nor the reference package, so on the GPU machine it
runs without them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerance: rel < 1e-5 against the plain version (both fp32, summed in
different orders).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import registry, transforms
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
