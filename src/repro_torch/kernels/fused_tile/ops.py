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

import weakref
from typing import Optional

import torch

from repro_torch.core import registry, tiling, transforms
from repro_torch.core.device import DeviceLike, is_transient, publish, resolve_device
from repro_torch.kernels.fused_tile import kernel as _kernel
from repro_torch.kernels.fused_tile import matrix as _matrix
from repro_torch.kernels.fused_tile.blocks import BlockConfig


# The tile engine's logical phases, in execution order.  One dispatch
# runs all five inside a single kernel launch (or, on the CPU, one chain
# of wide GEMMs), so they are announced through the phase hook rather
# than separately timed; the observability layer splits measured stage
# time across the GEMM phases by their MAC counts.
_PHASES = ("gather", "forward_gemm", "mix", "inverse_gemm", "scatter")

# Observability hook: when set (see obs.trace.capture_tile_phases), each
# conv2d_fused_tile dispatch calls it once per logical phase with
# (phase, info), where info carries the backend (torch-cuda / torch-cpu),
# the family and tile geometry, and on the card the geometry of the
# plan the kernel launches (`kernel.launch_plan`).  Fires on the host at
# dispatch.
_PHASE_HOOK = None


def set_phase_hook(hook):
    """Install the phase announcement hook; returns the previous one so
    callers can restore it (see `obs.trace.capture_tile_phases`)."""
    global _PHASE_HOOK
    prev = _PHASE_HOOK
    _PHASE_HOOK = hook
    return prev


class UnsupportedSpec(Exception):
    """The parametric engine cannot run this problem."""


def engine_supported(transform: transforms.Transform, dtype) -> bool:
    """Can the parametric engine run this family/dtype?"""
    # the f32 basis matrices would silently downgrade f64 precision
    return dtype != torch.float64


# Per-process memos of the kernel path's host-side set-up, so a served
# layer pays for them once: packed rhs per transformed-kernel tensor (and
# its version, so an in-place update repacks), R per shape, zero biases.
_PACKED: dict = {}  # id(wt) -> (weakref to wt, key, packed rhs)
_FIT_R: dict = {}
_ZERO_BIAS: dict = {}


def _packed_rhs(spec: transforms.TileKernelSpec, wt: torch.Tensor, groups: int):
    if is_transient(wt):  # one wave's gathered transform: packed for this call
        return spec.pack_rhs(wt, groups)
    key = (spec.family, spec.t, spec.k, groups, wt._version)
    hit = _PACKED.get(id(wt))
    if hit is None or hit[0]() is not wt or hit[1] != key:
        wid = id(wt)
        ref = weakref.ref(wt, lambda _, wid=wid: _PACKED.pop(wid, None))
        hit = (ref, key, publish(spec.pack_rhs(wt, groups)))
        _PACKED[wid] = hit
    return hit[2]


def _fit_r(spec: transforms.TileKernelSpec, r: int, c_in: int, c_out: int) -> int:
    key = (spec.family, spec.t, spec.k, r, c_in, c_out)
    if key not in _FIT_R:
        try:
            _FIT_R[key] = _kernel.fit_r(spec, r, c_in, c_out)
        except ValueError as e:
            _FIT_R[key] = UnsupportedSpec(str(e))
    hit = _FIT_R[key]
    if isinstance(hit, UnsupportedSpec):
        raise hit
    return hit


def _zero_bias(c_out: int, device) -> torch.Tensor:
    key = (c_out, device)
    if key not in _ZERO_BIAS:
        _ZERO_BIAS[key] = publish(torch.zeros((1, c_out), dtype=torch.float32, device=device))
    return _ZERO_BIAS[key]


def _announce_phases(spec, family, plan, x, groups, launch=None) -> None:
    """Fire the phase hook once per phase; on the card `launch` is the
    `kernel.launch_plan` the dispatch launches, whose geometry `info`
    reports."""
    info = {
        "backend": "torch-cuda" if x.device.type == "cuda" else "torch-cpu",
        "family": family,
        "t": spec.t,
        "t_out": spec.t_out,
        "planes": spec.planes,
        "n_tiles_h": plan.n_tiles_h,
        "n_tiles_w": plan.n_tiles_w,
        "groups": groups,
    }
    if launch is not None:
        g = launch.geo
        n_tiles = x.shape[0] * plan.n_tiles_h * plan.n_tiles_w
        info.update(r=g.r, ns=g.ns, sc=g.sc, n_split=g.n_split, na=g.na,
                    blocks=g.blocks(n_tiles, launch.out_shape[-1]))
    for phase in _PHASES:
        _PHASE_HOOK(phase, info)


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
    rhs = _packed_rhs(spec, wt.to(dev), groups)
    blocks = blocks or BlockConfig(r=24)
    plan = tiling.TilePlan.build(x.shape[1], x.shape[2], spec.k, pad, spec.t)

    if x.device.type == "cpu":
        if _PHASE_HOOK is not None:
            _announce_phases(spec, transform.family, plan, x, groups)
        xp = tiling.pad_input(x, plan)
        y = _matrix.matrix_tile_conv(
            xp, rhs, plan, spec, groups=groups, epilogue=epilogue,
            chunk=blocks.chunk(),
        )
        return y.to(x.dtype)
    if x.device.type != "cuda":
        raise UnsupportedSpec(f"no tile engine for device {x.device}")

    # Kernel path.  A block of the kernel takes at most R tiles (R only
    # groups independent tiles, so the output does not change); `fit_r`
    # lowers R until a block's buffer fits and raises when no R does.
    # The kernel splits the flattened tile population itself, so the
    # padded input needs no extra tile columns.
    c_in = x.shape[-1]
    c_out = rhs.shape[1] * rhs.shape[3] // spec.planes
    r = _fit_r(spec, blocks.r, c_in, c_out)
    xp = tiling.pad_input(x.to(torch.float32), plan).contiguous()

    ep_ops: tuple = ()
    biases = None
    post = None
    if isinstance(epilogue, registry.ElementwiseOps):
        ep_ops, biases = epilogue.kernel_form()
    elif epilogue is not None:
        post = epilogue  # opaque callable: post-pass on assembled output
    if biases is None:
        biases = _zero_bias(c_out, x.device)
    biases = biases.to(dev, torch.float32).contiguous()

    call = dict(spec=spec, n_tiles_h=plan.n_tiles_h, n_tiles_w=plan.n_tiles_w,
                r=r, groups=groups, ep_ops=ep_ops)
    if _PHASE_HOOK is not None:
        _announce_phases(spec, transform.family, plan, x, groups,
                         _kernel.launch_plan(xp, rhs, biases, **call))
    y = _kernel.fused_tile_call(xp, rhs, biases, **call)
    y = y[:, : plan.h_out, : plan.w_out, :]
    if post is not None:
        y = post(y)
    return y.to(x.dtype)
