"""The fused causal conv1d's entry point, plus its registry `Algorithm`:
temporal `ConvSpec`s (h == 1, causal left pad along w) plan and execute
through the same planner as the 2-D paths.

The device decides the path: a CUDA tensor launches the CUDA kernel
(`kernel.conv1d_fused_call`) or raises, a CPU tensor runs the plain
version (`ref.conv1d_ref`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import registry
from repro_torch.kernels.conv1d_fused import kernel as _kernel
from repro_torch.kernels.conv1d_fused.ref import conv1d_ref


def conv1d_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    activation: str = "silu",
    lb: int = 128,
) -> torch.Tensor:
    """Causal depthwise conv1d + bias + activation. x (B,L,D), w (K,D).

    The reference wrapper's semantics: K-1 zero rows before the sequence
    (causality), output length L, blocks of `lb` rows (the kernel's
    L-strip; the last one is ragged, masked in the kernel rather than
    padded).
    """
    if b is None:
        b = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
    if x.device.type == "cuda":
        return _kernel.conv1d_fused_call(
            x, w.contiguous(), b.contiguous(),
            strip=min(lb, x.shape[1]), activation=activation,
        )
    return conv1d_ref(x, w, b, activation=activation)


class Conv1dFusedAlgorithm(registry.Algorithm):
    """Temporal (1-D causal depthwise) convs through the registry.

    Domain: `ConvSpec.temporal` specs with depthwise channels
    (groups == c_in == c_out), unit stride, and same-length causal
    padding (pad == k - 1) -- the Mamba-family short conv.  Bias and
    activation epilogues arrive through the generic `fuse_epilogue`
    path, so the executor treats this like any other algorithm.
    Memory-bound by construction (k MACs per element moved), priced as
    such for auto ranking.
    """

    name = "conv1d_fused"
    tier = 0
    rank = 5
    consumes_wt = False
    auto_candidate = True
    chain_family = None  # 1-D stages never chain with the 2-D tiling

    def supports(self, spec: registry.ConvSpec) -> bool:
        return (
            spec.temporal
            and spec.groups == spec.c_in == spec.c_out
            and spec.stride == 1
            and spec.pad == spec.k - 1
            and spec.dtype in ("float32", "bfloat16")
        )

    def plan(self, spec, hw, *, hints=None, wisdom_path=None):
        hints = dict(hints or {})
        # AI: 2K flops per element against an 8-byte load+store round trip
        ai = 2.0 * spec.k / 8.0
        util = min(1.0, ai / hw.cmr_dram)
        return registry.AlgoPlan(
            self.name, spec,
            {"lb": int(hints.get("lb", 128))},
            predicted_util=util,
            cost=2.0 * spec.k / max(util, 0.05),
        )

    def execute(self, x, w, wt, plan):
        if wt is not None:
            raise ValueError("conv1d_fused consumes no pre-transformed wt")
        if x.shape[1] != 1:
            raise ValueError(
                f"temporal conv expects (B, 1, L, D) input, got {tuple(x.shape)}"
            )
        xs = x[:, 0]  # (B, L, D)
        wk = w[0, :, 0, :]  # HWIO (1, k, 1, D) -> (k, D)
        y = conv1d_fused(
            xs, wk, activation="none", lb=int(plan.params.get("lb", 128))
        )
        return y[:, None, :, :]


registry.register(Conv1dFusedAlgorithm())
