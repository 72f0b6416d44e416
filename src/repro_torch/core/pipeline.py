"""The transform-generic tile-pipeline engine.

One engine, every transform family.  `fused.py`, `three_stage.py` and
`fft_conv.py` drive it with a `Transform` object (core.transforms)
instead of inlined math:

  * `fused_tile_conv` -- the paper's L3-fused task structure, run by the
    parametric tile engine (`repro_torch.kernels.fused_tile`): tasks of
    R tiles, each gathering, forward-transforming, channel-mixing
    against the stationary right-hand matrices, inverse-transforming,
    and (optionally) running the fused elementwise epilogue while the
    tiles are still task-resident.  The per-task working set follows
    the shared-buffer layout of `core.sharedbuf`; the R bound the
    planner derives from it is family-exact through `TileAlgebra`.
  * `scan_tile_conv` -- the interpreting task scan: the same task
    structure in plain torch through each family's own forward /
    multiply / inverse, in the input's dtype.  It is the oracle the
    kernel is held against, and the path f64 takes on the CPU: the
    kernel's basis matrices are f32.
  * `staged_tile_conv` -- the vendor 3-stage structure: every stage runs
    over ALL tiles before the next begins, materializing the transformed
    tensors (what DNNL/ZNN/LIBXSMM do, and the paper's baseline), through
    the same `TileKernelSpec` (`staged_matrix_fns`).

Grouped convolutions are handled once, in the tile engine, for every
family: tiles are gathered with full channel width and the channel mix
runs block-diagonal, so registering a transform family never
re-implements groups.

`TransformedAlgorithm` is the registry face of the engine: a shared
plan/prepare/execute/fuse_epilogue lifecycle parameterized only by a
transform factory, so a concrete algorithm (`l3_fused`, `fft_fused`,
`three_stage`) is little more than a family + tier declaration.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.core import analysis, registry, tiling, transforms

# calls of `scan_tile_conv`: f64 inputs on the CPU and direct oracle
# calls, never an f32 served path (a run reads it to show that)
SCAN_CALLS = 0
_SCAN_LOCK = threading.Lock()  # replica threads call concurrently


def fused_tile_conv(
    x: torch.Tensor,
    w: Optional[torch.Tensor],
    transform: transforms.Transform,
    *,
    pad: int = 0,
    r_tiles: int = 24,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
    epilogue=None,
    blocks=None,
) -> torch.Tensor:
    """NHWC L3-fused transformed convolution, any transform family, on
    `x`'s device: the CUDA tile kernel for a CUDA tensor, its plain
    matrix version for a CPU tensor (`kernels.fused_tile`).

    `blocks` (a `kernels.fused_tile.BlockConfig`) carries the autotuned
    block shape; `r_tiles` alone seeds an unchunked default.  f64 inputs,
    which the f32 basis matrices would downgrade, run the interpreting
    `scan_tile_conv` (counted in `SCAN_CALLS`) on the CPU; on the card
    they reach the kernel wrapper, which raises `UnsupportedSpec` (call
    `scan_tile_conv` by name for the f64 oracle there).  Every other
    dtype goes to the tile engine, whose errors propagate.
    """
    from repro_torch.kernels import fused_tile as _ft

    if x.device.type == "cpu" and not _ft.engine_supported(transform, x.dtype):
        return scan_tile_conv(
            x, w, transform,
            pad=pad, r_tiles=r_tiles, wt=wt, groups=groups, epilogue=epilogue,
        )
    return _ft.conv2d_fused_tile(
        x, w, transform,
        pad=pad,
        blocks=blocks or _ft.BlockConfig(r=int(r_tiles)),
        wt=wt, groups=groups, epilogue=epilogue, device=x.device,
    )


def scan_tile_conv(
    x: torch.Tensor,
    w: Optional[torch.Tensor],
    transform: transforms.Transform,
    *,
    pad: int = 0,
    r_tiles: int = 24,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
    epilogue=None,
) -> torch.Tensor:
    """The interpreting task-scan engine, in plain torch on `x`'s device
    and in `x`'s dtype (the oracle the tile kernel is held against, and
    the path for f64 on the CPU, which the kernel cannot take).

    Tiles are processed in N_task = ceil(N_tile / R) independent tasks;
    each task forward-transforms its R tiles, mixes channels against the
    right-hand matrices and inverse-transforms, through the family's own
    `forward` / `multiply` / `inverse`.  `epilogue`, when given, is an
    elementwise callable applied to each task's (R, T', T', C') output
    tiles: output tiles abut, so this equals applying it to the
    assembled output.
    """
    global SCAN_CALLS
    with _SCAN_LOCK:
        SCAN_CALLS += 1
    plan = tiling.TilePlan.build(
        x.shape[1], x.shape[2], transform.k, pad, transform.t
    )
    if wt is None:
        wt = transform.kernel_transform(w)
    batch, t = x.shape[0], transform.t
    tiles = tiling.extract_tiles(tiling.pad_input(x, plan), plan)
    tiles = tiles.reshape(-1, t, t, x.shape[3])  # (N_tile, T, T, C)
    r = min(r_tiles, tiles.shape[0])
    out = []
    for a in range(0, tiles.shape[0], r):  # one task of R tiles
        u = transform.forward(tiles[a : a + r])  # step 1: basis change
        y = transform.inverse(transform.multiply(u, wt, groups))
        out.append(y if epilogue is None else epilogue(y))
    y_tiles = torch.cat(out).reshape(
        batch, plan.n_tiles_h, plan.n_tiles_w, plan.t_out, plan.t_out, -1
    )
    return tiling.assemble_tiles(y_tiles, plan).to(x.dtype)


def staged_tile_conv(
    x: torch.Tensor,
    w: Optional[torch.Tensor],
    transform: transforms.Transform,
    *,
    pad: int = 0,
    wt: Optional[torch.Tensor] = None,
    groups: int = 1,
) -> torch.Tensor:
    """The non-fused 3-stage structure (each stage over ALL tiles,
    materializing U and M between stages)."""
    from repro_torch.kernels.fused_tile import staged_matrix_fns

    plan = tiling.TilePlan.build(
        x.shape[1], x.shape[2], transform.k, pad, transform.t
    )
    if wt is None:
        wt = transform.kernel_transform(w)
    s1, s2, s3 = staged_matrix_fns(plan, transform.kernel_spec(), groups)
    xp = tiling.pad_input(x, plan)
    return s3(s2(s1(xp), wt), x.shape[0]).to(x.dtype)


# ------------------------------------------------------------------------
# Registry face: the shared lifecycle of every transformed algorithm.
# ------------------------------------------------------------------------


def resolve_r(
    spec: registry.ConvSpec,
    hw: analysis.HardwareModel,
    transform: transforms.Transform,
    *,
    hints,
    tune_r: bool = False,
    wisdom_path=None,
    device=None,
):
    """R for a transformed plan on `device`: explicit hint > measured (tune_r) >
    wisdom-file lookup > analytic prediction.  Wisdom entries are keyed
    by transform family + tile size + geometry, so Winograd-R and FFT-T
    tunes for the same layer never collide.  Returns (r, tuned) where
    `tuned` marks an R that came from measurement (fresh or cached in
    the wisdom file) rather than the model."""
    from repro_torch.core import tune  # deferred: tune times this module's conv

    r_hint = hints.get("r_tiles")
    if r_hint is not None:
        return int(r_hint), False
    if tune_r:
        r = tune.tuned_r(
            spec.h, spec.w, spec.c_in, spec.c_out,
            transform=transform, wisdom_path=wisdom_path, device=device,
        )
        return int(r), True
    r = tune.lookup_r(
        spec.h, spec.w, spec.c_in, spec.c_out,
        transform=transform, wisdom_path=wisdom_path, device=device,
    )
    if r is not None:
        # clamp a wisdom R measured elsewhere into this hw's feasible range
        r_max = analysis.max_r_ta(hw, spec.c_in, spec.c_out, transform.algebra)
        return (max(1, min(int(r), r_max)) if r_max >= 1 else int(r)), True
    return (
        tune.predict_r(spec.c_in, spec.c_out, transform=transform, hw=hw),
        False,
    )


class TransformedAlgorithm(registry.Algorithm):
    """Base class for algorithms realized by the shared tile engine.

    A subclass declares its transform family (`make_transform` + the
    name of its tile-size param) and its registry identity; planning,
    weight pre-transforms, execution, grouped support, stride-decimation
    and in-task epilogue fusion are all inherited.  `execute_staged`
    (cross-layer fusion groups) comes from `registry.Algorithm` and is
    generic over any engine-backed execute, which makes every transform
    family a first-class fusion-group citizen.
    """

    consumes_wt = True
    tile_param: str = ""  # "m" (Winograd) or "t_fft" (FFT)
    default_tile: int = 0  # default value of that param
    r_floor_base: int = 8  # family floor on a useful task width

    def make_transform(
        self, spec: registry.ConvSpec, params
    ) -> transforms.Transform:
        """The family's Transform at this plan's tile size."""
        raise NotImplementedError

    def supports(self, spec: registry.ConvSpec) -> bool:
        # the engine handles stride (decimation), groups (block-diagonal
        # mix) and ragged geometry for every family; dtype domains may
        # narrow this in subclasses.  Temporal (1-D causal) specs have
        # left-only pad semantics outside the 2-D tiling engine.
        return not spec.temporal

    def r_floor(self, hw: analysis.HardwareModel) -> int:
        return max(self.r_floor_base, analysis.min_r(hw) // 2)

    def plan(self, spec, hw, *, hints=None, tune_r=False, wisdom_path=None,
             device=None):
        hints = hints or {}
        tile = int(hints.get(self.tile_param) or self.default_tile)
        params = {self.tile_param: tile}
        tr = self.make_transform(spec, params)
        r, tuned = resolve_r(
            spec, hw, tr, hints=hints, tune_r=tune_r, wisdom_path=wisdom_path,
            device=device,
        )
        ta = tr.algebra
        util = analysis.predicted_utilization(
            hw, r, spec.c_in, spec.c_out, ta.t, ta.t_out, ta.alpha,
            spec.groups,
        )
        params = {**params, "r_tiles": int(r)}
        from repro_torch.core import tune

        blocks = tune.lookup_blocks(
            spec.h, spec.w, spec.c_in, spec.c_out,
            transform=tr, wisdom_path=wisdom_path, device=device,
        )
        if blocks is not None:
            params["blocks"] = blocks.to_wisdom()
        cost = registry.fused_auto_cost(
            spec, hw, ta, self.r_floor(hw), blocks=blocks
        )
        return registry.AlgoPlan(
            self.name, spec, params,
            predicted_util=util, cost=cost, tuned=tuned,
        )

    def tile_algebra(self, plan: registry.AlgoPlan):
        return self.make_transform(plan.spec, plan.params).algebra

    def prepare_weights(self, w, plan):
        if self.tile_param not in plan.params:
            raise ValueError(
                f"{self.name} plan without {self.tile_param}: {plan.params}"
            )
        return self.make_transform(plan.spec, plan.params).kernel_transform(w)

    def _run(self, x, w, wt, plan, epilogue):
        tr = self.make_transform(plan.spec, plan.params)
        blocks = None
        if "blocks" in plan.params:
            from repro_torch.kernels.fused_tile import BlockConfig

            blocks = BlockConfig.from_wisdom(plan.params["blocks"])
        return fused_tile_conv(
            x, w, tr,
            pad=plan.spec.pad,
            r_tiles=int(plan.params.get("r_tiles", 24)),
            wt=wt,
            groups=plan.spec.groups,
            epilogue=epilogue,
            blocks=blocks,
        )

    def execute(self, x, w, wt, plan):
        return registry.decimate(
            self._run(x, w, wt, plan, None), plan.spec.stride
        )

    def fuse_epilogue(self, plan, epilogue):
        # fold the elementwise glue into the task loop: it runs on the
        # (R, T', T', C') tiles while they are still task-resident,
        # instead of as a separate pass over the assembled output
        def run(x, w, wt):
            return registry.decimate(
                self._run(x, w, wt, plan, epilogue), plan.spec.stride
            )

        return run
