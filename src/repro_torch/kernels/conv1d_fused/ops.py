"""The fused causal conv1d's entry point, its gradient, and its registry
`Algorithm`: temporal `ConvSpec`s (h == 1, causal left pad along w) plan
and execute through the same planner as the 2-D paths.

The device decides the path: a CUDA tensor launches the CUDA kernel
(`kernel.conv1d_fused_call`) or raises, a CPU tensor runs the plain
version (`ref.conv1d_ref`).  Under grad, when an input requires it, the
call goes through `Conv1dFused` on either device: its forward is the
same launch, and its backward is the backward kernel
(`backward.conv1d_fused_bwd_call`) on the card, its plain version
(`ref.conv1d_bwd_ref`) on the CPU.  The reference never trains through
its Pallas conv (`use_pallas_conv` is off in every caller): its gradient
is XLA's, of the shifted-MAC conv plus SiLU, which is what both
compute.  A meta tensor runs neither kernel nor plain version: empty
meta outputs, the call reported with its cost (`kernels.meta`, the dry
run's op counter).  Both kernels take fp32 and bf16 (the backward's bf16 entry
sums in f32 and rounds each gradient once); on the card any other dtype
under grad raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import registry
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.conv1d_fused import backward as _backward
from repro_torch.kernels.conv1d_fused import kernel as _kernel
from repro_torch.kernels.conv1d_fused.ref import conv1d_bwd_ref, conv1d_ref


def _conv(x, w, b, activation: str) -> torch.Tensor:
    """One forward: the kernel for a CUDA tensor, the plain version for a
    CPU one."""
    if x.device.type == "cuda":
        return _kernel.conv1d_fused_call(x, w, b, activation=activation)
    if _meta.is_meta(x):
        _meta.record("conv1d_fused", _kernel.cost(*x.shape, w.shape[0], x.element_size()))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return conv1d_ref(x, w, b, activation=activation)


class Conv1dFused(torch.autograd.Function):
    """act(causal depthwise conv1d(x, w) + b) with its gradient.  Saves x,
    w and b (x may be a column slice of a wider activation: the slice is
    saved, not copied).  The backward's dx comes back contiguous in x's
    shape; autograd's slice backward scatters it into the wider
    activation's gradient."""

    @staticmethod
    def forward(ctx, x, w, b, activation: str):
        ctx.save_for_backward(x, w, b)
        ctx.activation = activation
        return _conv(x, w, b, activation)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dw, db = _backward.conv1d_fused_bwd_call(
                x, w, b, g.contiguous(), activation=ctx.activation)
        elif _meta.is_meta(x):
            _meta.record("conv1d_fused_bwd",
                         _backward.cost(*x.shape, w.shape[0], x.element_size()))
            dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            dw, db = torch.empty_like(w), torch.empty_like(b)
        else:
            dx, dw, db = conv1d_bwd_ref(g, x, w, b, activation=ctx.activation)
        return dx, dw, db, None


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
    (causality), output length L.  `lb` is the reference's L block (rows
    per grid step of its TPU kernel); it changes no result, and it sets
    nothing here: on the card each thread of the kernel takes a strip of
    `kernel.ROWS` rows, whatever `lb`.
    """
    if b is None:
        b = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
    w, b = w.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        if x.device.type == "cuda" and x.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"conv1d_fused under grad takes float32 or bfloat16 on the card, got "
                f"{x.dtype}: the backward kernel has no other instantiation")
        return Conv1dFused.apply(x, w, b, activation)
    return _conv(x, w, b, activation)


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
        """Any K, fp32 or bf16, as the reference's kernel takes them; on the
        card each executes through the kernel's instantiation of its dtype."""
        return (
            spec.temporal
            and spec.groups == spec.c_in == spec.c_out
            and spec.stride == 1
            and spec.pad == spec.k - 1
            and spec.dtype in ("float32", "bfloat16")
        )

    def plan(self, spec, hw, *, hints=None, tune_r=False, wisdom_path=None,
             device=None):
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
