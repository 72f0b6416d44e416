"""Live hierarchical-roofline attribution: measured seconds vs ceilings.

The paper's argument is a roofline argument -- a transformed conv wins
when its arithmetic intensity against each memory level clears that
level's compute-to-memory ratio (S5).  This module closes the loop at
serve time: join a stage's *measured* seconds (`profile_stages`) with
its `TileAlgebra` FLOP/byte terms and the calibrated `HardwareModel`
ceilings, and report per stage

  * achieved GFLOP/s and arithmetic intensity (DRAM and fast-level),
  * the **binding roofline level** -- which ceiling (DRAM bandwidth,
    shared-L3 bandwidth at AI_fast = R/2, or the fast-private compute
    peak) is lowest for this stage's intensities,
  * a predicted-vs-achieved verdict keyed ``backend:family:geometry``,

the paper's Figure 2/3 as queryable telemetry (`Telemetry.snapshot()`'s
``roofline`` section) and as `roofline.stage` trace instants.

On the H100 the paper's levels map as DRAM -> HBM3, shared L3 -> the
50 MB L2 that holds the stationary right-hand matrices, fast private ->
a block's shared memory and registers; the level names stay the
reference's.  The backend in a key is ``torch-cuda`` or ``torch-cpu``.

For fused/transformed stages the stage's measured time is additionally
split across the tile engine's logical phases (forward GEMM / mix /
inverse GEMM) proportionally to each phase's MAC count -- the phases
execute inside one kernel launch and cannot be timed separately, so
proportional-FLOPs attribution is the honest estimate.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core import analysis, registry

SCHEMA_VERSION = 2  # BENCH JSON / snapshot schema (v1 = unversioned)

# binding roofline levels, lowest-ceiling-wins
LEVEL_DRAM = "dram"
LEVEL_SHARED = "shared_l3"
LEVEL_PRIVATE = "fast_private"

# achieved/roof verdict bands: wide on purpose -- the verdict flags
# order-of-magnitude stories (a stage running at 3% of its roof), not
# calibration jitter
VERDICT_ABOVE = "above_model"  # achieved > roof: the model under-prices
VERDICT_AT = "at_roof"
VERDICT_BELOW = "below_roof"
VERDICT_FAR_BELOW = "far_below_roof"


def _backend() -> str:
    """Where this process runs by default (the wisdom keys' prefix)."""
    from repro_torch.core import tune

    return tune._backend()


def _unit_terms(u, batch: int) -> dict:
    """FLOPs / DRAM bytes / intensities for one stage unit (one conv)."""
    p = u.plan
    s = p.spec
    oh, ow = s.out_hw
    ta = registry.get(p.algo).tile_algebra(p.algo_plan())
    if ta is not None:
        # stride-1 tile grid, decimation after -- mirror the planner's
        # charge so predicted and achieved price the same work
        oh1 = s.h + 2 * s.pad - s.k + 1
        ow1 = s.w + 2 * s.pad - s.k + 1
        flops = ta.engine_flops(oh1, ow1, s.c_in, s.c_out, s.groups, batch)
        w_bytes = ta.kernel_matrix_bytes(s.c_in, s.c_out, s.groups)
        macs = ta.engine_macs_per_tile(s.c_in, s.c_out, s.groups)
        pl, dp = ta.planes, ta.domain_points
        fwd = pl * dp * ta.t * ta.t * s.c_in
        mix = dp * (pl * s.c_in) * (pl * s.c_out) // s.groups
        inv = ta.t_out * ta.t_out * pl * dp * s.c_out
        phase_macs = {"forward_gemm": fwd, "mix": mix, "inverse_gemm": inv}
        assert fwd + mix + inv == macs
        family = ta.family
    else:
        flops = 2 * batch * oh * ow * s.c_in * s.c_out * s.k * s.k // s.groups
        w_bytes = 4 * s.k * s.k * (s.c_in // s.groups) * s.c_out
        phase_macs = None
        family = p.algo
    act_bytes = 4 * batch * (s.h * s.w * s.c_in + oh * ow * s.c_out)
    r = p.params.get("r_tiles")
    return {
        "family": family,
        "algo": p.algo,
        "flops": int(flops),
        "dram_bytes": int(act_bytes + w_bytes),
        "ai_fast": analysis.ai_fast_level(int(r)) if r else None,
        "phase_macs": phase_macs,
        "geometry": (
            f"{s.h}x{s.w}x{s.c_in}->{s.c_out}:k{s.k}:s{s.stride}"
            f":g{s.groups}"
        ),
    }


def _binding(hw, ai_dram: float, ai_fast: Optional[float]) -> Tuple[str, float]:
    """(level, roof GFLOP-ceiling in FLOP/s): the lowest of the DRAM
    bandwidth roof, the shared-fast-level roof at AI_fast, and the
    compute peak (the fast-private level: working sets resident in
    private memory leave only the peak to bind)."""
    roofs = [(LEVEL_PRIVATE, hw.peak_flops),
             (LEVEL_DRAM, ai_dram * hw.dram_bw)]
    if ai_fast is not None:
        roofs.append((LEVEL_SHARED, ai_fast * hw.fast_shared_bw))
    level, roof = min(roofs, key=lambda kv: kv[1])
    return level, roof


def _verdict(frac_of_roof: float) -> str:
    if frac_of_roof > 1.1:
        return VERDICT_ABOVE
    if frac_of_roof >= 0.5:
        return VERDICT_AT
    if frac_of_roof >= 0.1:
        return VERDICT_BELOW
    return VERDICT_FAR_BELOW


def attribute_stage(
    stage,
    measured_s: float,
    hw: analysis.HardwareModel,
    *,
    batch: int = 1,
    predicted_s: Optional[float] = None,
    backend: Optional[str] = None,
) -> dict:
    """One stage's roofline row: achieved GFLOP/s, intensities, the
    binding level, the verdict, and per-phase attributed time."""
    units = [_unit_terms(u, batch) for u in stage.units]
    flops = sum(u["flops"] for u in units)
    dram_bytes = sum(u["dram_bytes"] for u in units)
    ai_dram = flops / dram_bytes if dram_bytes else 0.0
    fasts = [u["ai_fast"] for u in units if u["ai_fast"] is not None]
    ai_fast = min(fasts) if fasts else None  # the tightest unit binds
    level, roof = _binding(hw, ai_dram, ai_fast)
    achieved = flops / measured_s if measured_s > 0 else 0.0
    frac = achieved / roof if roof > 0 else 0.0
    be = backend or _backend()
    families = "+".join(dict.fromkeys(u["family"] for u in units))
    key = f"{be}:{families}:{units[0]['geometry']}"

    phases = None
    phase_units = [u for u in units if u["phase_macs"] is not None]
    if phase_units:
        totals = {"forward_gemm": 0, "mix": 0, "inverse_gemm": 0}
        for u in phase_units:
            for ph, m in u["phase_macs"].items():
                totals[ph] += m
        macs = sum(totals.values())
        phases = [
            {
                "phase": ph,
                "macs_frac": totals[ph] / macs if macs else 0.0,
                "attributed_us": (
                    measured_s * 1e6 * totals[ph] / macs if macs else 0.0
                ),
            }
            for ph in ("forward_gemm", "mix", "inverse_gemm")
        ]

    row = {
        "stage": stage.label,
        "key": key,
        "fused": bool(stage.fused),
        "measured_us": measured_s * 1e6,
        "flops": flops,
        "dram_bytes": dram_bytes,
        "achieved_gflops": achieved / 1e9,
        "ai_dram": ai_dram,
        "ai_fast": ai_fast,
        "binding_level": level,
        "roof_gflops": roof / 1e9,
        "frac_of_roof": frac,
        "verdict": _verdict(frac),
        "phases": phases,
    }
    if predicted_s is not None:
        row["predicted_us"] = predicted_s * 1e6
        row["measured_over_predicted"] = (
            measured_s / predicted_s if predicted_s > 0 else None
        )
    return row


def attribute_program(
    program,
    profile: Sequence[Tuple[str, float]],
    hw: analysis.HardwareModel,
    *,
    batch: int = 1,
    backend: Optional[str] = None,
) -> List[dict]:
    """Roofline rows for every profiled stage of an `ExecProgram`.  The
    planner's predictions ride along so the verdict can say both
    "how far under the roof" and "how far off the model".  `backend`
    names where the profile ran (default: this process's)."""
    from repro_torch.convserve import planner  # deferred: planner is heavy

    predicted = dict(planner.predict_stage_times(program, hw))
    backend = backend or _backend()
    rows = []
    by_label = {stage.label: stage for stage in program.stages}
    for label, seconds in profile:
        stage = by_label.get(label)
        if stage is None:
            continue
        rows.append(
            attribute_stage(
                stage, seconds, hw, batch=batch,
                predicted_s=(
                    predicted.get(label, 0.0) * batch
                    if predicted.get(label) is not None else None
                ),
                backend=backend,
            )
        )
    return rows


def roofline_section(
    program,
    profile: Sequence[Tuple[str, float]],
    hw: analysis.HardwareModel,
    *,
    batch: int = 1,
    tracer=None,
    backend: Optional[str] = None,
) -> dict:
    """The schema-stable ``roofline`` telemetry section.  With a tracer,
    each row is also recorded as a ``roofline.stage`` instant so traces
    carry their own attribution (`export.roofline_table` renders either
    form)."""
    rows = attribute_program(program, profile, hw, batch=batch, backend=backend)
    if tracer is not None and getattr(tracer, "enabled", False):
        for row in rows:
            args = {k: v for k, v in row.items() if k != "phases"}
            tracer.instant("roofline.stage", "roofline", **args)
    return {
        "schema_version": SCHEMA_VERSION,
        "hw": {
            "name": hw.name,
            "peak_gflops": hw.peak_flops / 1e9,
            "dram_gbs": hw.dram_bw / 1e9,
            "fast_shared_gbs": hw.fast_shared_bw / 1e9,
            "cmr_dram": hw.cmr_dram,
            "cmr_fast": hw.cmr_fast,
        },
        "batch": batch,
        "stages": rows,
    }
