"""The paper's contribution: the L3-fused transformed convolution.

Instead of three full-layer stages, tiles are processed in N_task =
ceil(N_tile / R) independent *tasks* (gather + forward-transform R tiles,
T^2 small matmuls against the *stationary* right-hand matrices, inverse-
transform), so the per-task intermediates stay in fast private memory and
the right-hand matrices stay hot in the fast shared level (L3 on the
CPU; the L2 on the GPU, read by the CUDA tile kernel in
repro_torch.kernels.fused_tile).

The task loop itself lives in `repro_torch.core.pipeline` -- one engine shared
by every transform family -- and this module is just the Winograd-family
binding: `conv2d_l3_fused` drives the engine with a `WinogradTransform`,
and `L3FusedAlgorithm` registers it (tier 0).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pipeline, registry, transforms


def conv2d_l3_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    pad: int = 0,
    m: Optional[int] = None,
    r_tiles: int = 24,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
    epilogue=None,
) -> torch.Tensor:
    """NHWC L3-fused Winograd convolution.

    Args:
      x: (B, H, W, C) input.
      w: (K, K, C/groups, C') kernels (HWIO); ignored if `wt` given.
      pad: symmetric spatial padding.
      m: Winograd output-tile size (T = m + K - 1).  Default m=5, T=7 --
         the paper's benchmark configuration.
      r_tiles: R, tiles per task (paper uses R=24 on SkylakeX, R=8 on i7).
      wt: pre-transformed kernels (T*T, C/groups, C') -- the inference-time
        path.
      groups: grouped convolution (block-diagonal channel mix).
      epilogue: optional elementwise callable applied to each task's
        output tiles inside the scan (bias/relu glue running on
        task-resident data); output tiles abut, so this equals applying
        it to the assembled output.

    Runs on `x`'s device (the CUDA tile kernel for a CUDA tensor).
    """
    k = w.shape[0]
    m = m if m is not None else 5  # T = 7, the paper's fixed benchmark config
    return pipeline.fused_tile_conv(
        x, w, transforms.WinogradTransform(m=m, k=k),
        pad=pad, r_tiles=r_tiles, wt=wt, groups=groups, epilogue=epilogue,
    )


class L3FusedAlgorithm(pipeline.TransformedAlgorithm):
    """The paper's contribution as a registry algorithm (tier 0)."""

    name = "l3_fused"
    tier = 0
    rank = 10
    weight_params = ("m",)
    chain_family = "winograd"
    tile_param = "m"
    default_tile = 5  # T = 7, the paper's benchmark configuration
    r_floor_base = 8

    def make_transform(self, spec, params):
        return transforms.WinogradTransform(m=int(params["m"]), k=spec.k)


registry.register(L3FusedAlgorithm())
