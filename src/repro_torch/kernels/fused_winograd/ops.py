"""The fused Winograd path, as a thin instantiation of the tile kernel.

The reference package keeps `conv2d_fused_pallas` and the registry
algorithm `l3_fused_pallas` as the Winograd instantiation of its
parametric Pallas tile engine.  Here both are pinned to the CUDA tile
kernel (`repro_torch.kernels.fused_tile.conv2d_fused_tile`) driven by a
`WinogradTransform`: a CUDA tensor launches the kernel, a CPU tensor
runs its plain version.  The names stay the reference's, so code and
saved plans that name them run unchanged.  No kernel of its own.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import registry, transforms
from repro_torch.core.device import DeviceLike
from repro_torch.core.fused import L3FusedAlgorithm


def conv2d_fused_pallas(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    pad: int = 0,
    m: Optional[int] = None,
    r_tiles: int = 16,
    groups: int = 1,
    epilogue=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """NHWC (B,H,W,C) x HWIO (K,K,C/g,C') -> NHWC, through the tile
    kernel instantiated with the Winograd F(m, K) transform (m 5 by
    default), R `r_tiles` tiles per task, on `device` (cuda unless the
    caller names another).  Grouped convolutions run block-diagonal
    inside the one kernel; a `registry.ElementwiseOps` `epilogue` folds
    into its scatter phase."""
    # deferred: importing the tile engine imports `core`, which registers
    # this module's algorithm
    from repro_torch.kernels.fused_tile import BlockConfig, conv2d_fused_tile

    tr = transforms.WinogradTransform(m=m if m is not None else 5, k=w.shape[0])
    return conv2d_fused_tile(
        x, w, tr,
        pad=pad,
        blocks=BlockConfig(r=int(r_tiles), tasks_per_program=1),
        groups=groups, epilogue=epilogue, device=device,
    )


class L3FusedPallasAlgorithm(L3FusedAlgorithm):
    """The Winograd instantiation of the tile kernel as a registry
    algorithm, under the reference's name.

    Shares the Winograd family's plan step (same transform, same
    family-keyed wisdom R) but is explicit-only (`auto_candidate =
    False`), as in the reference: auto planning picks `l3_fused`, which
    runs the same kernel.  It transforms its weights on every call, so it
    has no ahead-of-time prepare step and never consumes a cached `wt`.
    """

    name = "l3_fused_pallas"
    tier = 0
    rank = 15
    consumes_wt = False
    weight_params = ()
    auto_candidate = False
    chain_family = "winograd"  # chains with l3_fused

    def prepare_weights(self, w, plan):
        return None

    def _call(self, x, w, plan, epilogue):
        y = conv2d_fused_pallas(
            x, w, pad=plan.spec.pad, m=plan.params.get("m"),
            r_tiles=int(plan.params.get("r_tiles", 16)),
            groups=plan.spec.groups, epilogue=epilogue, device=x.device,
        )
        return registry.decimate(y, plan.spec.stride)

    def execute(self, x, w, wt, plan):
        return self._call(x, w, plan, None)

    def fuse_epilogue(self, plan, epilogue):
        # structured glue folds into the kernel's scatter phase; opaque
        # callables post-pass (base Algorithm path)
        if isinstance(epilogue, registry.ElementwiseOps):
            return lambda x, w, wt: self._call(x, w, plan, epilogue)
        return registry.Algorithm.fuse_epilogue(self, plan, epilogue)


registry.register(L3FusedPallasAlgorithm())
