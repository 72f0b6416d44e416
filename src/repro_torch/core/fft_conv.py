"""FFT-based transformed convolution (the paper's second transform family).

Same OLA tiling and task structure as the Winograd path -- literally the
same code now: the task loop lives in `repro_torch.core.pipeline` and this
module drives it with an `FFTTransform` (rfft basis, channel mix per
frequency as a complex matmul; alpha = 2 in the paper's FLOP accounting).
Cross-correlation comes via the correlation theorem; the circular
wrap-around only contaminates the last K-1 rows/cols, which OLA discards.

Being engine-backed makes FFT a first-class fusion-group citizen: it
inherits in-task epilogue fusion (`fuse_epilogue`) and generic staged
chain execution (`execute_staged`), so the planner may build FFT-backed
cross-layer fusion groups exactly as it does Winograd ones.  bf16 inputs
take a real reduced-precision path (FFT computed in fp32, assembled
output cast back) rather than a capability fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pipeline, registry, transforms


def transform_kernels_fft(w: torch.Tensor, t: int) -> torch.Tensor:
    """HWIO (K, K, C, C') -> (T, T//2+1, C, C') complex right-hand matrices."""
    return transforms.FFTTransform(t=t, k=w.shape[0]).kernel_transform(w)


def conv2d_fft_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    pad: int = 0,
    t: int = 16,
    r_tiles: int = 16,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
    epilogue=None,
) -> torch.Tensor:
    """NHWC L3-fused FFT convolution (paper: T >= 16 works well for FFT)."""
    return pipeline.fused_tile_conv(
        x, w, transforms.FFTTransform(t=t, k=w.shape[0]),
        pad=pad, r_tiles=r_tiles, wt=wt, groups=groups, epilogue=epilogue,
    )


class FFTFusedAlgorithm(pipeline.TransformedAlgorithm):
    """The FFT transform family as a registry algorithm (tier 0).

    alpha = 2 in the cost entry (complex channel-mix matmuls) with the
    rfft half-spectrum's complex working set priced exactly through
    `TileAlgebra`; feasible only when the padded input covers a full
    T_fft tile -- below that the tile is mostly padding and the
    flops-per-pixel comparison collapses.
    """

    name = "fft_fused"
    tier = 0
    rank = 20
    weight_params = ("t_fft",)
    chain_family = "fft"
    tile_param = "t_fft"
    default_tile = 16  # the paper: T >= 16 works well for FFT
    r_floor_base = 4

    def supports(self, spec: registry.ConvSpec) -> bool:
        # torch.fft computes in f32/f64; bf16/fp16 kernels ride the fp32
        # transform.  Temporal (1-D causal) specs have different pad
        # semantics and belong to the conv1d algorithm.
        return not spec.temporal and spec.dtype in (
            "float32", "float64", "bfloat16", "float16"
        )

    def make_transform(self, spec, params):
        return transforms.FFTTransform(t=int(params["t_fft"]), k=spec.k)


registry.register(FFTFusedAlgorithm())
