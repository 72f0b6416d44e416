"""The state-of-the-art *non-fused* 3-stage transformed convolution.

This is the structure the paper attributes to DNNL / ZNN / LIBXSMM / FALCON
(and uses as its own baseline): each stage runs over ALL tiles before the
next begins, materialising the full transformed tensors (left-hand
matrices U and products M) in main memory (HBM on the GPU).  Stages 1 and 3
are memory-bound; stage 2 is the only potentially compute-bound part
(paper S3).

The stages themselves come from the shared tile engine
(`repro_torch.core.pipeline.staged_tile_conv`, through the tile kernel's
own `TileKernelSpec`) driven by a `WinogradTransform`; this module binds
them to the Winograd family and registers the tier-1 fallback
algorithm.  Run eagerly, each stage's output is a full tensor in main
memory, which is exactly the materialisation behaviour of the vendor
libraries.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import analysis, pipeline, registry, transforms


def transform_kernels(w: torch.Tensor, m: int) -> torch.Tensor:
    """HWIO kernels (K, K, C, C') -> right-hand matrices (T*T, C, C').

    Done once ahead of time (paper footnote 1: transformed kernels are
    precomputed and stored for inference; see also Liu et al. for training).
    """
    return transforms.WinogradTransform(m=m, k=w.shape[0]).kernel_transform(w)


def conv2d_three_stage(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    pad: int = 0,
    m: Optional[int] = None,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
) -> torch.Tensor:
    """NHWC x (B,H,W,C), HWIO w (K,K,C,C') -> (B,H',W',C')."""
    m = m if m is not None else 6  # T = 8 default
    return pipeline.staged_tile_conv(
        x, w, transforms.WinogradTransform(m=m, k=w.shape[0]),
        pad=pad, wt=wt, groups=groups,
    )


class ThreeStageAlgorithm(pipeline.TransformedAlgorithm):
    """The vendor-structure baseline as a registry algorithm.

    Tier 1: always roofline-feasible (stages stream through DRAM), so it
    is the fallback whenever every fused path is infeasible -- but never
    beats a feasible fused path regardless of modeled cost, matching the
    paper's preference order.  `chain_family` stays None: the 3-stage
    baseline *is* the materializing structure, so it never joins fusion
    groups.
    """

    name = "three_stage"
    tier = 1
    rank = 30
    weight_params = ("m",)
    tile_param = "m"
    default_tile = 6  # T = 8, this module's historical default

    def make_transform(self, spec, params):
        return transforms.WinogradTransform(m=int(params["m"]), k=spec.k)

    def plan(self, spec, hw, *, hints=None, tune_r=False, wisdom_path=None,
             device=None):
        hints = hints or {}
        m = int(hints.get("m") or self.default_tile)
        ta = transforms.WinogradTransform(m=m, k=spec.k).algebra
        # DRAM roofline bounds utilisation: U and M round-trip main memory.
        util = min(
            1.0,
            analysis.ai_dram(
                spec.c_in, spec.c_out, ta.t, ta.t_out, ta.alpha, spec.groups
            )
            / hw.cmr_dram,
        )
        cost = math.inf
        if spec.padded_min >= ta.t:  # tile-fit heuristic gates auto only
            cost = (
                ta.flops_per_output_px() / max(util, 1e-9) * spec.stride**2
            )
        return registry.AlgoPlan(
            self.name, spec, {"m": m}, predicted_util=util, cost=cost
        )

    def _run(self, x, w, wt, plan, epilogue):
        # materializing structure: no task loop to fold an epilogue into
        # (the base fuse_epilogue applies it to the assembled output)
        tr = self.make_transform(plan.spec, plan.params)
        y = pipeline.staged_tile_conv(
            x, w, tr, pad=plan.spec.pad, wt=wt, groups=plan.spec.groups
        )
        return y if epilogue is None else epilogue(y)


registry.register(ThreeStageAlgorithm())
