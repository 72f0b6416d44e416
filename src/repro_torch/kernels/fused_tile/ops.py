"""Entry point of the parametric fused tile engine.

`conv2d_fused_tile` runs one transformed convolution through a
`TileKernelSpec`.  The device picks the path:

  * a CUDA tensor launches the hand-written tile kernel
    (`kernel.fused_tile_call`, `csrc/fused_tile.cu`), or raises -- it
    never falls back;
  * a CPU tensor runs the kernel's plain PyTorch version
    (`matrix.matrix_tile_conv`): the same math as three wide GEMMs.

f64 inputs have no f32 basis matrices and raise `UnsupportedSpec`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import registry, tiling, transforms
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.fused_tile import kernel as _kernel
from repro_torch.kernels.fused_tile import matrix as _matrix
from repro_torch.kernels.fused_tile.blocks import BlockConfig


class UnsupportedSpec(Exception):
    """The parametric engine cannot run this problem."""


def engine_supported(transform: transforms.Transform, dtype) -> bool:
    """Can the parametric engine run this family/dtype?"""
    # the f32 basis matrices would silently downgrade f64 precision
    return dtype != torch.float64


def conv2d_fused_tile(
    x,
    w,
    transform: transforms.Transform,
    *,
    pad: int = 0,
    blocks: Optional[BlockConfig] = None,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
    epilogue=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """NHWC fused transformed convolution through the parametric kernel,
    on `device` (cuda unless the caller names another; `x`, `w` and
    `wt` are moved there).

    `wt` is the *family-native* transformed kernel (what
    `Transform.kernel_transform` returns and the kernel cache stores);
    packing into the engine's real mix layout happens here.  `epilogue`
    may be a `registry.ElementwiseOps` (folded into the CUDA kernel's
    scatter phase) or any elementwise callable (applied to output tiles
    on the matrix path, post-pass on the kernel path).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if x.dtype == torch.float64:
        raise UnsupportedSpec("f64 inputs: basis matrices are f32")
    spec = transform.kernel_spec()
    if wt is None:
        wt = transform.kernel_transform(torch.as_tensor(w, device=dev))
    rhs = spec.pack_rhs(wt.to(dev), groups)
    blocks = blocks or BlockConfig(r=24)
    plan = tiling.TilePlan.build(x.shape[1], x.shape[2], spec.k, pad, spec.t)

    if x.device.type == "cpu":
        xp = tiling.pad_input(x, plan)
        y = _matrix.matrix_tile_conv(
            xp, rhs, plan, spec, groups=groups, epilogue=epilogue,
            chunk=blocks.chunk(),
        )
        return y.to(x.dtype)
    if x.device.type != "cuda":
        raise UnsupportedSpec(f"no tile engine for device {x.device}")

    # Kernel path.  One thread block runs one task of R tiles, so R is
    # lowered to the largest value whose aliased buffer fits a block's
    # shared memory (the planner's R already fits half of it; the
    # untuned default of 24 may not) -- R only groups independent
    # tiles, so the output does not change.  The column tile count is
    # aligned to R with zero tile columns, cropped after the kernel.
    c_in = x.shape[-1]
    c_out = rhs.shape[1] * rhs.shape[3] // spec.planes
    try:
        r = _kernel.fit_r(
            spec, min(blocks.r, plan.n_tiles_w), c_in, c_out
        )
    except ValueError as e:
        raise UnsupportedSpec(str(e)) from None
    run_plan = _matrix.pallas_block_geometry(plan, r) or plan
    xp = tiling.pad_input(x.to(torch.float32), run_plan).contiguous()

    ep_ops: tuple = ()
    biases = None
    post = None
    if isinstance(epilogue, registry.ElementwiseOps):
        ep_ops, biases = epilogue.kernel_form()
    elif epilogue is not None:
        post = epilogue  # opaque callable: post-pass on assembled output
    if biases is None:
        biases = torch.zeros((1, c_out), dtype=torch.float32, device=dev)

    y = _kernel.fused_tile_call(
        xp, rhs, biases.to(dev, torch.float32).contiguous(),
        spec=spec,
        n_tiles_h=run_plan.n_tiles_h,
        n_tiles_w=run_plan.n_tiles_w,
        r=r,
        groups=groups,
        ep_ops=ep_ops,
    )
    y = y[:, : plan.h_out, : plan.w_out, :]
    if post is not None:
        y = post(y)
    return y.to(x.dtype)
