"""Public convolution API: a thin dispatcher over the algorithm registry.

    conv2d(x, w, pad=1)                        # algo="auto": registry cost
                                               # model + wisdom file
    conv2d(x, w, pad=1, algo="l3_fused")       # the paper's contribution
    conv2d(x, w, pad=1, algo="three_stage")    # vendor-structure baseline
    conv2d(x, w, pad=1, algo="fft_fused")      # FFT-basis fused variant
    conv2d(x, w, pad=1, algo="direct")         # cuDNN direct conv
    conv2d(x, w, pad=1, stride=2)              # strided (ResNet downsample)
    conv2d(x, w, pad=1, groups=4)              # grouped (ResNeXt-style)
    conv2d(x, w, plan=layer_plan, wt=cached)   # convserve engine path: a
                                               # planned layer with its
                                               # pre-transformed kernels
    conv2d(x, w, pad=1, device="cpu")          # on the CPU (default: cuda)

`conv2d` itself knows no algorithm: every path -- capability checks, the
roofline cost ranking, R resolution through the wisdom file, weight
pre-transforms, execution -- goes through `repro_torch.core.registry`.
Adding an algorithm is a single `registry.register()` call; this module
never changes.

Layout: NHWC activations, HWIO kernels at every public function (the
reference package's layout); `conv2d_direct` converts to NCHW/OIHW only
internally.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import analysis, registry
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.fft_conv import conv2d_fft_fused  # noqa: F401  (re-export +
from repro_torch.core.fused import conv2d_l3_fused  # noqa: F401      registers the
from repro_torch.core.three_stage import conv2d_three_stage  # noqa: F401  algos)
from repro_torch.kernels.conv1d_fused import ops as _conv1d_ops

if TYPE_CHECKING:  # convserve imports core; keep the runtime edge one-way
    from repro_torch.convserve.plan import LayerPlan


def conv2d_direct(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    pad: int = 0,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """The framework's own convolution (cuDNN on the GPU) -- the
    vendor-library stand-in, with TF32 off so it is a full-fp32 oracle.

    Supports the full problem space: strided, grouped (HWIO kernels carry
    C/groups input channels), non-square, any float dtype.
    """
    with torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, allow_tf32=False
    ):
        y = F.conv2d(
            x.permute(0, 3, 1, 2),  # NHWC -> NCHW
            w.permute(3, 2, 0, 1),  # HWIO -> OIHW
            stride=stride, padding=pad, groups=groups,
        )
    return y.permute(0, 2, 3, 1).contiguous()


class DirectAlgorithm(registry.Algorithm):
    """Tier 2: the universal fallback.  Supports everything (stride,
    groups, non-square, any dtype); chosen by auto only when no
    transformed path is roofline-feasible (e.g. spatial dims too small
    to cover one tile)."""

    name = "direct"
    tier = 2
    rank = 50
    consumes_wt = False

    def supports(self, spec: registry.ConvSpec) -> bool:
        # temporal (1-D causal) specs carry left-only pad semantics the
        # symmetric-pad 2-D path cannot express
        return not spec.temporal

    def plan(self, spec, hw, *, hints=None, wisdom_path=None):
        return registry.AlgoPlan(
            self.name, spec, {}, predicted_util=1.0, cost=0.0
        )

    def execute(self, x, w, wt, plan):
        return conv2d_direct(
            x, w,
            pad=plan.spec.pad, stride=plan.spec.stride,
            groups=plan.spec.groups,
        )


registry.register(DirectAlgorithm())


def conv2d(
    x,
    w,
    *,
    pad: int = 0,
    stride: int = 1,
    groups: int = 1,
    algo: str = "auto",
    m: Optional[int] = None,
    t_fft: Optional[int] = None,
    r_tiles: Optional[int] = None,
    hw: Optional[analysis.HardwareModel] = None,
    plan: "Optional[Union[LayerPlan, registry.AlgoPlan]]" = None,
    wt: Optional[torch.Tensor] = None,
    wisdom_path=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC, on `device` (cuda unless
    the caller names another; `x`, `w` and `wt` are moved there).

    With algo="auto" the registry ranks every feasible algorithm by the
    S5 roofline model of `hw` (default: the device's own model,
    `tune.default_hw`) and resolves R through the wisdom file (a tuned R
    for this geometry is used when one exists; `tune.predict_r`
    otherwise).  `m`/`t_fft`/`r_tiles` are optional hints overriding the
    planned algorithm's own defaults.

    A `plan` (convserve LayerPlan or a registry AlgoPlan) overrides
    algo/pad/stride/groups and all params with the planner's per-layer
    decision; `wt` supplies pre-transformed right-hand matrices (the
    inference-time kernel-cache path).  Supplying `wt` to an algorithm
    that cannot consume it (direct) is an error -- precomputed work is
    never silently dropped.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if w is not None:
        w = torch.as_tensor(w, device=dev)
    if wt is not None:
        wt = wt.to(dev)
    if plan is not None:
        aplan = plan.algo_plan() if hasattr(plan, "algo_plan") else plan
    else:
        from repro_torch.core import tune

        spec = registry.ConvSpec.from_tensors(
            x, w, pad=pad, stride=stride, groups=groups
        )
        hints = {
            name: val
            for name, val in (("m", m), ("t_fft", t_fft), ("r_tiles", r_tiles))
            if val is not None
        }
        aplan = registry.plan_conv(
            spec, hw or tune.default_hw(dev), algo=algo, hints=hints,
            wisdom_path=wisdom_path,
        )
    alg = registry.get(aplan.algo)
    if wt is not None and not alg.consumes_wt:
        raise ValueError(
            f"algo {aplan.algo!r} does not consume pre-transformed kernels: "
            "a supplied `wt` would silently drop precomputed work.  Pass "
            "wt=None, or plan an algorithm with consumes_wt=True."
        )
    return alg.execute(x, w, wt, aplan)


def conv1d_depthwise_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, L, D), w (K, D) -> (B, L, D).

    The Mamba-family short conv, without bias or activation.  The device
    decides the path as everywhere in the port: a CUDA tensor launches
    the fused conv1d kernel, a CPU tensor runs its plain version.  (The
    reference's ``use_pallas=True`` spelling also applies SiLU, unlike its
    default path; this is the default path's function.)
    """
    return _conv1d_ops.conv1d_fused(x, w, activation="none")
