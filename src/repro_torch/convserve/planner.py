"""Roofline planner: per-layer algorithm + R selection, then cross-layer
fusion-group selection, for a whole net.

For every conv layer the planner poses a `ConvSpec` to the algorithm
registry (`registry.plan_conv`), which ranks every supporting, feasible
algorithm by the S5 analytical model -- L3-fused Winograd, L3-fused FFT,
the vendor 3-stage structure, or the direct convolution when the layer is
too small to tile.  R comes from the registry's plan step: an explicit
hint, the wisdom file (`tune.lookup_r` / the measuring `tune.tuned_r`
with ``tune_r=True``), or the analytic `tune.predict_r`.

On top of the per-layer decisions, `plan_fusion_groups` walks adjacent
conv units and charges the same roofline currency at the net level: a
fusion group skips the DRAM round trip of the intermediate activation
(2 x H x W x C x 4 bytes at `dram_bw`) at the price of recomputing
(K-1)-row halos at super-tile seams; it is admitted only where the
chained algorithms share a tiling family (`Algorithm.can_chain`), the
group's right-hand matrices jointly fit the fast shared level, and the
saved traffic exceeds the recompute time.

The planner itself names no algorithm: a newly registered algorithm is
planned for -- and chained -- automatically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core import analysis, registry
from repro_torch.core import tune as tune_mod
from repro_torch.convserve import program as program_mod
from repro_torch.convserve.graph import NetSpec
from repro_torch.convserve.plan import FusionGroup, LayerPlan, NetPlan


def plan_layer(
    hw: analysis.HardwareModel,
    layer: int,
    spec: registry.ConvSpec,
    *,
    m: int = 5,
    t_fft: int = 16,
    consider_fft: bool = True,
    tune_r: bool = False,
    wisdom_path=None,
    allowed: Optional[Sequence[str]] = None,
    device=None,
    costs=None,
) -> LayerPlan:
    """Plan one conv layer posed as a ConvSpec, for `device` (the wisdom
    file's keys; `tune_r` measures there).

    With `costs` (a measured-cost view, see `convserve.adapt.costs`), the
    roofline's tier-ranked choice can be overridden by measurement: when
    the model's winner has a measured time for this geometry and another
    supporting algorithm measured strictly faster, the faster one is
    planned instead -- ranked purely by seconds, ignoring the registry
    tier order that the analytic path uses."""
    if allowed is None:
        allowed = registry.names()
    if not consider_fft:
        allowed = tuple(n for n in allowed if n != "fft_fused")
    ap = registry.plan_conv(
        spec, hw,
        algo="auto",
        hints={"m": m, "t_fft": t_fft},
        allowed=allowed,
        tune_r=tune_r,
        wisdom_path=wisdom_path,
        device=device,
    )
    if costs is not None:
        measured = {}
        for name in allowed:
            alg = registry.get(name)
            if not (alg.auto_candidate and alg.supports(spec)):
                continue
            t = costs.algo_time_s(name, spec)
            if t is not None:
                measured[name] = t
        t_model = measured.get(ap.algo)
        if t_model is not None and measured:
            best = min(measured, key=measured.get)
            if best != ap.algo and measured[best] < t_model:
                ap = registry.plan_conv(
                    spec, hw,
                    algo=best,
                    hints={"m": m, "t_fft": t_fft},
                    tune_r=tune_r,
                    wisdom_path=wisdom_path,
                    device=device,
                )
    return LayerPlan.from_algo_plan(layer, ap)


def plan_net(
    spec: NetSpec,
    h: int,
    w: int,
    *,
    hw: Optional[analysis.HardwareModel] = None,
    m: int = 5,
    t_fft: int = 16,
    consider_fft: bool = True,
    tune_r: bool = False,
    wisdom_path=None,
    dtype: str = "float32",
    fuse: bool = True,
    allowed: Optional[Sequence[str]] = None,
    device=None,
    costs=None,
) -> NetPlan:
    """Plan every conv layer of `spec` at reference input (h, w), then
    (``fuse=True``) the cross-layer fusion groups on top.  `allowed`
    restricts the algorithm candidates per layer (e.g. ``("direct",)``
    for a bitwise-reproducible baseline plan).  `device` is where the
    plan runs: the wisdom file is read (and, with ``tune_r``, measured)
    for it.  `costs` threads a measured-cost view through both the
    per-layer choice and the fusion verdict (see `plan_layer` /
    `_group_decision`)."""
    hw = hw or tune_mod.default_hw(device)
    convs = spec.conv_layers()
    if not convs:
        raise ValueError(f"net {spec.name!r} has no conv layers")
    c0 = convs[0][1].c_in
    shapes = spec.infer_shapes(h, w, c0)
    plans = []
    cur_h, cur_w = h, w
    for i, layer in enumerate(spec.layers):
        if layer.kind == "conv":
            cspec = registry.ConvSpec(
                h=cur_h, w=cur_w,
                c_in=layer.c_in, c_out=layer.c_out, k=layer.k,
                pad=layer.pad, stride=layer.stride, groups=layer.groups,
                dtype=dtype,
            )
            plans.append(
                plan_layer(
                    hw, i, cspec,
                    m=m, t_fft=t_fft, consider_fft=consider_fft,
                    tune_r=tune_r, wisdom_path=wisdom_path, allowed=allowed,
                    device=device, costs=costs,
                )
            )
        cur_h, cur_w = shapes[i][0], shapes[i][1]
    plan = NetPlan(
        net=spec.name, hw=hw.name, dtype=dtype,
        input_hw=(h, w), layers=tuple(plans),
    )
    return (
        plan_fusion_groups(spec, plan, hw, costs=costs) if fuse else plan
    )


# ------------------------------------------------- cross-layer fusion


# fraction of the fast shared level a fusion group's resident slab (the
# super-tile of the largest intermediate) may occupy -- the rest holds
# the group's right-hand matrices (the same residency budget the
# per-layer feasibility gate uses) and the per-task private intermediates
_SLAB_FRAC = 0.25
_MATRIX_FRAC = analysis.MATRIX_RESIDENCY_FRAC


def _conv_time_s(p: LayerPlan, hw: analysis.HardwareModel) -> float:
    """Modeled wall time of one conv at its reference geometry.
    Deliberately reconstructible from a deserialized plan (v2 files keep
    predicted_util but not the auto-ranking cost).

    Transformed algorithms are priced by the FLOPs the parametric tile
    engine actually executes (forward + mix + inverse GEMMs over the full
    stride-1 tile grid, `TileAlgebra.engine_flops`) -- the direct-conv
    FLOP count used to stand in for every algorithm, which is why
    measured/predicted ratios ran orders of magnitude apart between
    families.  Direct convs keep the `analysis.conv_time_s` charge."""
    s = p.spec
    ta = registry.get(p.algo).tile_algebra(p.algo_plan())
    if ta is not None and ta.t_out >= 1 and not s.temporal:
        oh1 = s.h + 2 * s.pad - s.k + 1
        ow1 = s.w + 2 * s.pad - s.k + 1
        flops = ta.engine_flops(oh1, ow1, s.c_in, s.c_out, s.groups)
        return flops / (hw.peak_flops * max(p.predicted_util, 0.05))
    oh, ow = s.out_hw
    return analysis.conv_time_s(
        hw, out_h=oh, out_w=ow, c_in=s.c_in, c_out=s.c_out, k=s.k,
        groups=s.groups, predicted_util=p.predicted_util,
    )


def predict_stage_times(program, hw: analysis.HardwareModel) -> list:
    """Roofline prediction per ExecProgram stage: ``[(label, seconds)]``.
    A fused stage is priced as the sum of its members' modeled conv
    times (the model's fusion benefit lives in the group *decision*, not
    in the per-conv time) -- the prediction side that `convserve.adapt`
    compares measured stage timings (`CompiledNet.profile_stages`)
    against."""
    return [
        (
            stage.label,
            sum(_conv_time_s(u.plan, hw) for u in stage.units),
        )
        for stage in program.stages
    ]


def _group_decision(
    members: List[LayerPlan],
    hw: analysis.HardwareModel,
    *,
    max_tiles: int,
    costs=None,
) -> Optional[int]:
    """Roofline verdict on fusing `members` into one stage.

    Returns the super-tile row count (0 == untiled) when fusing wins,
    None when it does not.  With `costs`, a measured verdict replaces
    the saved-vs-extra model when both sides have been measured: fuse
    iff the measured group time beats the sum of the members' measured
    single-stage times.  Structural gates (chain family, matrix
    residency, slab feasibility) still apply either way.  Charged model:

      saved  = sum over interior boundaries of 2 x H x W x C x 4 bytes
               at dram_bw        (the skipped write+read round trip)
      extra  = (n_tiles - 1) x halo rows recomputed per seam, where the
               halo of intermediate j is sum of (K-1) over later convs
               (receptive-field growth), each row at that conv's modeled
               time per output row
    """
    # joint right-hand matrices must stay resident in the shared level --
    # priced family-exactly (complex rfft half-spectrum for FFT members)
    # through each algorithm's TileAlgebra
    matrix_bytes = 0
    for p in members:
        ta = registry.get(p.algo).tile_algebra(p.algo_plan())
        if ta is None:  # no transform family (direct): never chained
            return None
        matrix_bytes += ta.kernel_matrix_bytes(p.c_in, p.c_out, p.groups)
    if matrix_bytes > _MATRIX_FRAC * hw.fast_shared_bytes:
        return None
    # intermediates: input geometry of each member after the first
    inter = [(p.spec.h, p.spec.w, p.spec.c_in) for p in members[1:]]
    slab_row_bytes = max(w * c * 4 for _, w, c in inter)
    h_final, _ = members[-1].spec.out_hw
    budget = _SLAB_FRAC * hw.fast_shared_bytes
    tile_rows = int(budget // slab_row_bytes) - (members[-1].k - 1)
    if tile_rows < 1:
        return None  # one slab row set cannot stay resident
    if tile_rows >= h_final:
        n_tiles = 1
    else:
        n_tiles = math.ceil(h_final / tile_rows)
        if n_tiles > max_tiles:
            return None  # seam recompute (and trace size) out of hand
    if costs is not None:
        t_group = costs.group_time_s(members)
        singles = [costs.algo_time_s(p.algo, p.spec) for p in members]
        if t_group is not None and all(t is not None for t in singles):
            if t_group >= sum(singles):
                return None
            return 0 if n_tiles == 1 else tile_rows
    saved_s = sum(2 * h * w * c * 4 for h, w, c in inter) / hw.dram_bw
    extra_s = 0.0
    for j, p in enumerate(members[:-1]):
        halo = sum(q.k - 1 for q in members[j + 1 :])
        time_per_row = _conv_time_s(p, hw) / max(p.spec.out_hw[0], 1)
        extra_s += (n_tiles - 1) * halo * time_per_row
    if saved_s <= extra_s:
        return None
    return 0 if n_tiles == 1 else tile_rows


def plan_fusion_groups(
    spec: NetSpec,
    plan: NetPlan,
    hw: Optional[analysis.HardwareModel] = None,
    *,
    max_tiles: int = 8,
    costs=None,
) -> NetPlan:
    """Derive the cross-layer fusion groups for an already layer-planned
    net: greedy extension over adjacent conv units, gated by algorithm
    chainability, structural legality (no pooling mid-group), and the
    roofline benefit model (`_group_decision`)."""
    hw = hw or tune_mod.default_hw()
    _, units = program_mod.split_units(spec)
    plans = {p.layer: p for p in plan.layers}
    groups: List[FusionGroup] = []
    members: List[LayerPlan] = []
    tile_rows = 0

    def flush():
        nonlocal members, tile_rows
        if len(members) > 1:
            groups.append(
                FusionGroup(
                    layers=tuple(p.layer for p in members),
                    tile_rows=tile_rows,
                )
            )
        members, tile_rows = [], 0

    for pos, (conv_idx, ops) in enumerate(units):
        p = plans.get(conv_idx)
        if p is None:
            raise ValueError(f"plan missing conv layer {conv_idx}")
        if members:
            prev = members[-1]
            prev_ops = units[pos - 1][1]
            chainable = (
                not any(op.kind == "maxpool" for op in prev_ops)
                and registry.get(prev.algo).can_chain(
                    prev.algo_plan(), p.algo_plan()
                )
            )
            if chainable:
                verdict = _group_decision(
                    members + [p], hw, max_tiles=max_tiles, costs=costs
                )
                if verdict is not None:
                    members.append(p)
                    tile_rows = verdict
                    continue
            flush()
        members = [p]
    flush()
    return dataclasses.replace(plan, groups=tuple(groups))


def upgrade_plan(
    spec: NetSpec,
    plan: NetPlan,
    hw: Optional[analysis.HardwareModel] = None,
) -> NetPlan:
    """v2 -> v3 migration: a v2 plan file carries the identical per-layer
    decisions but no fusion groups; re-derive them from the same roofline
    model.  A v3 plan that already has groups passes through unchanged."""
    if plan.groups:
        return plan
    return plan_fusion_groups(spec, plan, hw)

