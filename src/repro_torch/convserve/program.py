"""Execution-program IR: the staged form a `NetPlan` lowers into.

The interpreter the engine used to be -- walk `NetSpec.layers`, switch on
layer kind, re-materialize every full activation between convs -- is
replaced by an explicit two-level IR:

    NetSpec + NetPlan --lower()--> ExecProgram = [Stage, Stage, ...]

Each `Stage` owns one conv *unit* (a `StageUnit`: the conv's `LayerPlan`
plus its fused epilogue -- the bias/relu/pool glue that used to be
interpreter cases) or, when the planner emitted a `FusionGroup`, several
transform-compatible adjacent units that execute as ONE resident stage:
conv -> epilogue -> conv over row super-tiles with halo recompute
(`Algorithm.execute_staged`), never materializing the full activation at
the layer boundary.  This is the paper's L3-residency argument lifted
from a single conv's three stages to the net level: exactly the
small-channel layers whose transform steps dominate are the ones whose
intermediates fit -- and stay -- in the fast shared level.

The IR is pure data (derivable from `NetSpec` + `NetPlan` v3, so plan
JSON round-trips reproduce identical stages); `executor.NetExecutor` is
a thin runner over it and `engine.Engine` the public front-end.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.convserve.check.diagnostics import program_error
from repro_torch.convserve.graph import LayerSpec, NetSpec
from repro_torch.convserve.plan import NetPlan

EPILOGUE_KINDS = ("bias", "relu", "maxpool")


@dataclasses.dataclass(frozen=True)
class EpilogueOp:
    """One pointwise/pooling glue op folded into a stage.

    `layer` is the op's NetSpec layer index -- provenance, and the
    weights key for bias vectors.  Elementwise ops (bias, relu) may run
    inside the owning algorithm's task loop; maxpool changes geometry
    and always ends a unit's in-tile region.
    """

    kind: str
    layer: int
    window: int = 1  # maxpool only

    def __post_init__(self):
        if self.kind not in EPILOGUE_KINDS:
            raise program_error(
                "CVK104", f"unknown epilogue kind {self.kind!r}"
            )

    @property
    def elementwise(self) -> bool:
        return self.kind != "maxpool"

    @staticmethod
    def from_layer(idx: int, layer: LayerSpec) -> "EpilogueOp":
        return EpilogueOp(kind=layer.kind, layer=idx, window=layer.window)


@dataclasses.dataclass(frozen=True)
class StageUnit:
    """One conv plus its fused epilogue (everything up to the next conv)."""

    plan: "LayerPlan"  # noqa: F821 -- repro_torch.convserve.plan.LayerPlan
    epilogue: Tuple[EpilogueOp, ...] = ()

    @property
    def layer(self) -> int:
        return self.plan.layer

    @property
    def has_pool(self) -> bool:
        return any(op.kind == "maxpool" for op in self.epilogue)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One execution stage: a single unit, or a fusion group of >= 2
    units that run conv -> epilogue -> conv without re-materializing the
    intermediate activation (`tile_rows` bounds the resident slab)."""

    units: Tuple[StageUnit, ...]
    tile_rows: int = 0

    def __post_init__(self):
        if not self.units:
            raise program_error("CVK104", "stage with no units")
        # pool inside a fusion group would change the coordinate system
        # mid-chain; lowering only ever places it in the final unit
        for u in self.units[:-1]:
            if u.has_pool:
                raise program_error(
                    "CVK110",
                    f"maxpool inside fusion group (layer {u.layer}): pool "
                    "must end a group",
                )

    @property
    def fused(self) -> bool:
        return len(self.units) > 1

    @property
    def conv_layers(self) -> Tuple[int, ...]:
        return tuple(u.layer for u in self.units)

    @property
    def label(self) -> str:
        if self.fused:
            return "fuse[" + "+".join(str(i) for i in self.conv_layers) + "]"
        return f"conv{self.units[0].layer}"


@dataclasses.dataclass(frozen=True)
class ExecProgram:
    """The staged execution program for one net under one NetPlan."""

    net: str
    prologue: Tuple[EpilogueOp, ...]  # glue before the first conv (rare)
    stages: Tuple[Stage, ...]

    @property
    def n_fused(self) -> int:
        return sum(1 for s in self.stages if s.fused)

    def describe(self) -> str:
        """One line per stage -- what the bench/report surfaces."""
        lines = []
        for s in self.stages:
            algos = ";".join(u.plan.algo for u in s.units)
            tail = f" tile_rows={s.tile_rows}" if s.fused else ""
            lines.append(f"{s.label:12s} {algos}{tail}")
        return "\n".join(lines)


def split_units(
    spec: NetSpec,
) -> Tuple[Tuple[EpilogueOp, ...], List[Tuple[int, Tuple[EpilogueOp, ...]]]]:
    """Partition a net's layers into per-conv units.

    Returns (prologue, units) where `prologue` is any glue before the
    first conv and each unit is ``(conv_layer_index, epilogue_ops)`` --
    the epilogue being every non-conv layer up to the next conv.
    """
    prologue: List[EpilogueOp] = []
    units: List[Tuple[int, Tuple[EpilogueOp, ...]]] = []
    current: Optional[int] = None
    ops: List[EpilogueOp] = []
    for i, layer in enumerate(spec.layers):
        if layer.kind == "conv":
            if current is not None:
                units.append((current, tuple(ops)))
            current, ops = i, []
        elif layer.kind in EPILOGUE_KINDS:
            (ops if current is not None else prologue).append(
                EpilogueOp.from_layer(i, layer)
            )
        else:
            raise program_error(
                "CVK104", f"layer {i}: unknown kind {layer.kind!r}"
            )
    if current is not None:
        units.append((current, tuple(ops)))
    return tuple(prologue), units


def lower(spec: NetSpec, plan: NetPlan) -> ExecProgram:
    """NetSpec + NetPlan -> ExecProgram.

    Validates the plan against the spec (coverage, geometry, net name)
    and the fusion groups against the unit structure (adjacency, no
    mid-group pooling) so a stale or hand-edited plan file fails here,
    not at request time.
    """
    if plan.net != spec.name:
        raise program_error(
            "CVK101",
            f"plan is for net {plan.net!r}, spec is {spec.name!r}",
        )
    plans = {p.layer: p for p in plan.layers}
    for i, layer in spec.conv_layers():
        p = plans.get(i)
        if p is None:
            raise program_error("CVK102", f"plan missing conv layer {i}")
        s = p.spec
        got = (s.c_in, s.c_out, s.k, s.pad, s.stride, s.groups)
        want = (
            layer.c_in, layer.c_out, layer.k, layer.pad,
            layer.stride, layer.groups,
        )
        if got != want:
            raise program_error(
                "CVK103",
                f"plan layer {i} geometry {got} != spec {want} "
                "(stale plan file?)",
            )
    prologue, units = split_units(spec)
    unit_pos = {conv_idx: pos for pos, (conv_idx, _) in enumerate(units)}
    grouped = {}
    for g in plan.groups:
        positions = []
        for conv_idx in g.layers:
            if conv_idx not in unit_pos:
                raise program_error(
                    "CVK107",
                    f"fusion group {g.layers} names layer {conv_idx}, which "
                    "is not a conv layer of the net",
                )
            positions.append(unit_pos[conv_idx])
        if positions != list(range(positions[0], positions[0] + len(positions))):
            raise program_error(
                "CVK108",
                f"fusion group {g.layers} is not a run of adjacent convs",
            )
        for conv_idx in g.layers:
            if conv_idx in grouped:
                raise program_error(
                    "CVK109",
                    f"layer {conv_idx} appears in two fusion groups",
                )
            grouped[conv_idx] = g
    stages: List[Stage] = []
    pos = 0
    while pos < len(units):
        conv_idx, ops = units[pos]
        g = grouped.get(conv_idx)
        if g is not None and g.layers[0] == conv_idx:
            members = []
            for member_idx in g.layers:
                midx, mops = units[unit_pos[member_idx]]
                members.append(StageUnit(plan=plans[midx], epilogue=mops))
            stages.append(Stage(units=tuple(members), tile_rows=g.tile_rows))
            pos += len(g.layers)
        else:
            stages.append(
                Stage(units=(StageUnit(plan=plans[conv_idx], epilogue=ops),))
            )
            pos += 1
    return ExecProgram(net=spec.name, prologue=prologue, stages=tuple(stages))
