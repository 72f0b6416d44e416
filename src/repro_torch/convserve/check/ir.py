"""IR verifier: abstract interpretation over an `ExecProgram`.

`verify_program(spec, plan)` re-derives, statically, every invariant the
planner relied on when it emitted the plan and the executor will rely on
when it runs the lowered program — so a machine-generated (or
hand-edited, or stale) plan is rejected *before* it binds weights or
reaches a replica:

  * structural legality — `program.lower` itself (coverage, geometry,
    group adjacency, pool placement); its `ProgramError`s are folded
    into the report under their own codes (CVK101..CVK110),
  * shape/dtype propagation — walk the stage chain from the plan's
    reference `input_hw`, checking every unit's declared ConvSpec
    geometry against the running shape, the channel chain across units,
    pool divisibility under stride (`downsample_factor` consistency),
    and the final shape against `NetSpec.infer_shapes`
    (CVK105/106/113/116),
  * fusion-group legality — the working-set terms the planner charged:
    joint right-hand matrices within `MATRIX_RESIDENCY_FRAC` of the
    shared level (CVK112), the resident slab (`tile_rows` + halo) within
    the slab budget (CVK111), members chainable under one transform
    family (CVK115),
  * halo recursion — expand the receptive-field recursion
    (`Algorithm.execute_staged`'s `want` ranges) over every super-tile
    and check no member is asked for rows outside its padded true
    extent, i.e. no phantom rows (CVK116),
  * kernel-cache key injectivity — two units with distinct weights must
    never share a static `KernelCache.key`, and a unit whose params
    dropped a declared weight param is under-keyed (CVK114).

The verifier never executes anything: it needs the spec, the plan, and a
hardware model (for the residency budgets), nothing else.  On the card
that model is `analysis.H100_SXM` (calibrated or not: calibration moves
only the roofs): the shared level is the 50 MB L2, the private level an
SM's shared memory.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import analysis, registry
from repro_torch.core import tune as tune_mod
from repro_torch.convserve.check.diagnostics import (
    CheckReport,
    Diagnostic,
    ProgramError,
)
from repro_torch.convserve.graph import NetSpec
from repro_torch.convserve.plan import NetPlan
from repro_torch.convserve.program import ExecProgram, Stage, lower

# the planner's residency fractions — verified against the SAME constants
# the decision used, so verifier and planner cannot drift apart silently
from repro_torch.convserve.planner import _SLAB_FRAC  # noqa: F401  (re-exported)

_MATRIX_FRAC = analysis.MATRIX_RESIDENCY_FRAC


def _err(report: CheckReport, code: str, msg: str, loc: str) -> None:
    report.add(Diagnostic(code=code, message=msg, loc=loc))


# ----------------------------------------------------------- shape chain


def _walk_shapes(
    report: CheckReport,
    spec: NetSpec,
    plan: NetPlan,
    program: ExecProgram,
) -> None:
    """Propagate (h, w, c) through every stage and unit, checking each
    unit's declared ConvSpec against the running shape and the epilogue
    pools against divisibility.  Mirrors `NetSpec.infer_shapes`, but
    against the PLAN's declared geometry, not the spec's — that is the
    whole point: the spec is trusted, the plan is the artifact under
    verification."""
    h, w = plan.input_hw
    c0 = spec.conv_layers()[0][1].c_in
    try:
        want_final = spec.out_shape(h, w, c0)
    except ValueError as e:
        _err(report, "CVK113", f"input_hw {plan.input_hw} does not survive "
             f"the net's downsampling chain: {e}", plan.net)
        return
    c = c0
    for op in program.prologue:
        if op.kind == "maxpool":
            if h % op.window or w % op.window:
                _err(
                    report, "CVK113",
                    f"prologue layer {op.layer}: pool window {op.window} "
                    f"does not divide ({h}, {w})", plan.net,
                )
                return
            h, w = h // op.window, w // op.window
    for stage in program.stages:
        for u in stage.units:
            s = u.plan.spec
            loc = f"{plan.net}/{stage.label}/layer{u.layer}"
            if (s.h, s.w) != (h, w):
                _err(
                    report, "CVK116",
                    f"layer {u.layer} planned at {s.h}x{s.w}, shape "
                    f"propagation reaches it at {h}x{w}", loc,
                )
            if s.c_in != c:
                _err(
                    report, "CVK106",
                    f"layer {u.layer} expects c_in={s.c_in}, channel chain "
                    f"carries {c}", loc,
                )
            if s.dtype != plan.dtype:
                _err(
                    report, "CVK105",
                    f"layer {u.layer} planned for dtype {s.dtype!r}, plan "
                    f"dtype is {plan.dtype!r}", loc,
                )
            try:
                h, w = s.out_hw
            except ValueError as e:
                _err(report, "CVK113", f"layer {u.layer}: {e}", loc)
                return
            c = s.c_out
            for op in u.epilogue:
                if op.kind == "maxpool":
                    if h % op.window or w % op.window:
                        _err(
                            report, "CVK113",
                            f"layer {op.layer}: pool window {op.window} "
                            f"does not divide ({h}, {w})", loc,
                        )
                        return
                    h, w = h // op.window, w // op.window
    got_final = (h, w, c)
    if got_final != want_final:
        _err(
            report, "CVK116",
            f"stage chain produces {got_final}, NetSpec.infer_shapes "
            f"expects {want_final}", plan.net,
        )


# -------------------------------------------------------- fusion groups


def _check_group(
    report: CheckReport,
    plan: NetPlan,
    stage: Stage,
    hw: analysis.HardwareModel,
) -> None:
    """Fusion-group legality: the working-set budgets `_group_decision`
    charged, re-derived from the lowered stage."""
    loc = f"{plan.net}/{stage.label}"
    members = [u.plan for u in stage.units]
    # dtype must agree across the seam: the intermediate is handed from
    # one member's inverse transform straight to the next member's
    # forward transform, with no cast in between
    dtypes = {p.spec.dtype for p in members}
    if len(dtypes) > 1:
        _err(
            report, "CVK105",
            f"fusion group mixes dtypes {sorted(dtypes)} across a seam",
            loc,
        )
    # chainability + joint matrix residency via each member's TileAlgebra
    matrix_bytes = 0
    for prev, nxt in zip(members, members[1:]):
        try:
            chains = registry.get(prev.algo).can_chain(
                prev.algo_plan(), nxt.algo_plan()
            )
        except Exception as e:
            chains = False
            _err(
                report, "CVK115",
                f"layers {prev.layer}->{nxt.layer}: chain probe failed "
                f"({e})", loc,
            )
        if not chains:
            _err(
                report, "CVK115",
                f"layers {prev.layer}->{nxt.layer} cannot chain "
                f"({prev.algo} -> {nxt.algo})", loc,
            )
            return
    for p in members:
        try:
            ta = registry.get(p.algo).tile_algebra(p.algo_plan())
        except Exception as e:
            _err(
                report, "CVK115",
                f"layer {p.layer} ({p.algo}): transform params are "
                f"unusable ({e})", loc,
            )
            return
        if ta is None:
            _err(
                report, "CVK115",
                f"layer {p.layer} ({p.algo}) has no transform family: "
                "cannot join a fusion group", loc,
            )
            return
        matrix_bytes += ta.kernel_matrix_bytes(p.c_in, p.c_out, p.groups)
    if matrix_bytes > _MATRIX_FRAC * hw.fast_shared_bytes:
        _err(
            report, "CVK112",
            f"joint right-hand matrices {matrix_bytes}B exceed "
            f"{_MATRIX_FRAC:.0%} of the shared level "
            f"({int(_MATRIX_FRAC * hw.fast_shared_bytes)}B)", loc,
        )
    # resident slab: the super-tile of the largest intermediate plus the
    # last conv's (K-1)-row halo must fit the planner's slab budget
    inter = [(p.spec.h, p.spec.w, p.spec.c_in) for p in members[1:]]
    slab_row_bytes = max(w_ * c_ * 4 for _, w_, c_ in inter)
    h_final, _ = members[-1].spec.out_hw
    k_last = members[-1].k
    eff_rows = stage.tile_rows if stage.tile_rows > 0 else h_final
    budget = _SLAB_FRAC * hw.fast_shared_bytes
    need = (eff_rows + k_last - 1) * slab_row_bytes
    if need > budget:
        _err(
            report, "CVK111",
            f"tile_rows={stage.tile_rows} needs a {need}B resident slab, "
            f"budget is {int(budget)}B ({_SLAB_FRAC:.0%} of the shared "
            "level)", loc,
        )
    _check_halo(report, plan, stage, loc)


def _check_halo(
    report: CheckReport, plan: NetPlan, stage: Stage, loc: str
) -> None:
    """Expand `execute_staged`'s receptive-field recursion over every
    super-tile: each member's wanted row range, before clamping, must
    stay within its padded input extent — a range reaching further would
    read phantom rows the clamp silently fabricates as zeros."""
    members = [u.plan for u in stage.units]
    h_final = members[-1].spec.h + 2 * members[-1].pad - members[-1].k + 1
    rows = stage.tile_rows if stage.tile_rows > 0 else h_final
    if rows <= 0 or h_final <= 0:
        _err(
            report, "CVK111",
            f"non-positive effective tile_rows/extent ({rows}, {h_final}) "
            "in fused stage", loc,
        )
        return
    a = 0
    while a < h_final:
        b = min(a + rows, h_final)  # output rows [a, b) of the stage
        lo, hi = a, b
        for p in reversed(members):
            s = p.spec
            # half-open input row range this member needs for output rows
            # [lo, hi) -- the same recursion execute_staged runs
            want_lo, want_hi = lo - s.pad, hi - s.pad + s.k - 1
            if want_lo < -s.pad or want_hi > s.h + s.pad:
                _err(
                    report, "CVK116",
                    f"halo recursion for output rows [{a}, {b}) asks "
                    f"layer {p.layer} for input rows "
                    f"[{want_lo}, {want_hi}) outside its padded extent "
                    f"[{-s.pad}, {s.h + s.pad}) (phantom rows)", loc,
                )
                return
            # clamp to the true extent, exactly as execute_staged does,
            # before recursing into the producer
            lo, hi = max(want_lo, 0), min(want_hi, s.h)
        a = b


# ----------------------------------------------------- cache-key checks


def _check_cache_keys(
    report: CheckReport, plan: NetPlan, program: ExecProgram
) -> None:
    """`KernelCache.key` injectivity over this program's units.

    Two distinct units sharing a static key would serve each other's
    transforms; a unit whose params dropped one of its algorithm's
    declared weight params is under-keyed — the key no longer separates
    two plans of the same layer with different transform settings, so a
    shared cache can hand back a transform prepared for the wrong tile
    size."""
    seen = {}
    for stage in program.stages:
        for u in stage.units:
            p = u.plan
            alg = registry.get(p.algo)
            if not alg.consumes_wt:
                continue
            loc = f"{plan.net}/{stage.label}/layer{u.layer}"
            missing = [
                name for name in alg.weight_params if name not in p.params
            ]
            if missing:
                _err(
                    report, "CVK114",
                    f"layer {u.layer} ({p.algo}) is missing declared "
                    f"weight params {missing}: prepare_key degenerates "
                    "and distinct transforms collide", loc,
                )
            s = p.spec
            try:
                pkey = alg.prepare_key(p.params)
            except Exception:
                pkey = None  # missing params already flagged above
            key = (
                plan.net, p.layer, p.algo, s.k, s.c_in, s.c_out, s.groups,
                pkey,
            )
            if key in seen:
                _err(
                    report, "CVK114",
                    f"units {seen[key]} and {loc} share one kernel-cache "
                    "key: distinct weights would collide", loc,
                )
            else:
                seen[key] = loc


# --------------------------------------------------- hand-built programs


def _check_structure(
    report: CheckReport, plan: NetPlan, program: ExecProgram
) -> None:
    """Re-assert the invariants `Stage.__post_init__` enforces, for
    programs built outside `lower()` (the dataclass checks can be
    bypassed with object.__setattr__; the verifier cannot)."""
    for stage in program.stages:
        loc = f"{plan.net}/{stage.label}"
        if not stage.units:
            _err(report, "CVK104", "stage with no units", loc)
            continue
        for u in stage.units[:-1]:
            if u.has_pool:
                _err(
                    report, "CVK110",
                    f"maxpool inside fusion group (layer {u.layer}): pool "
                    "must end a group — it would run inside the task loop",
                    loc,
                )
        if stage.fused and stage.tile_rows < 0:
            _err(
                report, "CVK111",
                f"negative tile_rows {stage.tile_rows}", loc,
            )


# ------------------------------------------------------------ entrypoint


def verify_program(
    spec: NetSpec,
    plan: NetPlan,
    *,
    program: Optional[ExecProgram] = None,
    hw: Optional[analysis.HardwareModel] = None,
) -> CheckReport:
    """Statically verify `plan` (or an already-lowered `program`) against
    `spec` on hardware model `hw`.  Never raises for plan defects — every
    finding lands in the returned `CheckReport`; `report.ok` is the
    verdict."""
    hw = hw or tune_mod.default_hw()
    report = CheckReport(analyzer="ir")
    if program is None:
        try:
            program = lower(spec, plan)
        except ProgramError as e:
            report.add(e.diagnostic)
            return report
        except ValueError as e:  # non-coded lowering failure
            report.add(
                Diagnostic(code="CVK104", message=str(e), loc=plan.net)
            )
            return report
    _check_structure(report, plan, program)
    _walk_shapes(report, spec, plan, program)
    _check_cache_keys(report, plan, program)
    for stage in program.stages:
        if stage.fused:
            _check_group(report, plan, stage, hw)
    return report


def verify_compiled(net, hw=None) -> CheckReport:
    """Convenience: verify a `CompiledNet`-shaped object (anything with
    `.spec`, `.plan`, `.program`)."""
    return verify_program(
        net.spec, net.plan, program=net.program,
        hw=hw or getattr(net, "hw", None),
    )
