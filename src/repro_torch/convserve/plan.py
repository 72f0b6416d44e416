"""Serializable per-layer algorithm plans (the net-level "wisdom file").

A `NetPlan` records, for every conv layer of a `NetSpec`, the problem it
was planned for (a `ConvSpec`), which algorithm the roofline planner
picked, and that algorithm's own params dict -- JSON on disk next to the
per-op wisdom file, so a planned net can be shipped to serving hosts
without re-planning (or re-measuring).

A `LayerPlan` is exactly `ConvSpec + algorithm name + algorithm-owned
params`: nothing in this module (or the cache/executor that consume it)
interprets the params -- only the owning registry algorithm does.

Plan format v3 adds `FusionGroup`s: the planner's cross-layer decisions
(which adjacent convs execute as one resident stage, and the super-tile
row count bounding the live intermediate).  v2 files still load --
their groups are empty, and `planner.upgrade_plan` re-derives them from
the same roofline model (see `convserve.program` for the staged IR the
executor lowers a NetPlan into).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import registry
from repro_torch.core.registry import AlgoPlan, ConvSpec

PLAN_VERSION = 3
_READABLE_VERSIONS = (2, 3)  # v2: per-layer only, no fusion groups


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The planner's decision for one conv layer.

    `spec` records what the layer was planned *for*: the executor applies
    algo + params to whatever shape bucket arrives, and the kernel cache
    keys transforms on the spec geometry plus the algorithm's declared
    weight params.  Convenience properties expose the common fields.
    """

    layer: int  # index into NetSpec.layers
    algo: str
    spec: ConvSpec
    params: Dict[str, Any]
    predicted_util: float = 0.0
    tuned: bool = False  # R came from measurement, not the model

    def __post_init__(self):
        if self.algo not in registry.names():
            raise ValueError(
                f"unknown algo {self.algo!r}, expected one of "
                f"{registry.names()}"
            )

    # ----- convenience views (geometry lives in spec, knobs in params)

    @property
    def pad(self) -> int:
        return self.spec.pad

    @property
    def stride(self) -> int:
        return self.spec.stride

    @property
    def groups(self) -> int:
        return self.spec.groups

    @property
    def c_in(self) -> int:
        return self.spec.c_in

    @property
    def c_out(self) -> int:
        return self.spec.c_out

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def h(self) -> int:
        return self.spec.h

    @property
    def w(self) -> int:
        return self.spec.w

    @property
    def r_tiles(self) -> int:
        return int(self.params.get("r_tiles", 0))

    @property
    def m(self) -> Optional[int]:
        return self.params.get("m")

    @property
    def t_fft(self) -> Optional[int]:
        return self.params.get("t_fft")

    @property
    def t(self) -> Optional[int]:
        """Transform tile size T, whichever family is planned."""
        if "t_fft" in self.params:
            return self.params["t_fft"]
        if "m" in self.params:
            return self.params["m"] + self.spec.k - 1
        return None

    def algo_plan(self) -> AlgoPlan:
        """The registry-level view: what execute()/prepare_weights() take."""
        return AlgoPlan(
            algo=self.algo, spec=self.spec, params=dict(self.params),
            predicted_util=self.predicted_util, tuned=self.tuned,
        )

    @staticmethod
    def from_algo_plan(layer: int, ap: AlgoPlan) -> "LayerPlan":
        return LayerPlan(
            layer=layer, algo=ap.algo, spec=ap.spec, params=dict(ap.params),
            predicted_util=ap.predicted_util, tuned=ap.tuned,
        )

    def to_dict(self) -> dict:
        return {
            "layer": self.layer,
            "algo": self.algo,
            "spec": self.spec.to_dict(),
            "params": dict(self.params),
            "predicted_util": self.predicted_util,
            "tuned": self.tuned,
        }

    @staticmethod
    def from_dict(d: dict) -> "LayerPlan":
        return LayerPlan(
            layer=d["layer"],
            algo=d["algo"],
            spec=ConvSpec.from_dict(d["spec"]),
            params=dict(d["params"]),
            predicted_util=d.get("predicted_util", 0.0),
            tuned=d.get("tuned", False),
        )


@dataclasses.dataclass(frozen=True)
class FusionGroup:
    """One cross-layer fusion decision: the conv layers (NetSpec indices,
    adjacent in conv order) that execute as a single resident stage, and
    the super-tile row count that bounds the live intermediate (0 means
    untiled -- the whole extent fits the fast shared level)."""

    layers: Tuple[int, ...]
    tile_rows: int = 0

    def __post_init__(self):
        if len(self.layers) < 2:
            raise ValueError(
                f"fusion group needs >= 2 conv layers, got {self.layers}"
            )
        if self.tile_rows < 0:
            raise ValueError(f"negative tile_rows in {self}")

    def to_dict(self) -> dict:
        return {"layers": list(self.layers), "tile_rows": self.tile_rows}

    @staticmethod
    def from_dict(d: dict) -> "FusionGroup":
        return FusionGroup(
            layers=tuple(d["layers"]), tile_rows=d.get("tile_rows", 0)
        )


@dataclasses.dataclass(frozen=True)
class NetPlan:
    """All layer plans (and fusion groups) for one net on one hardware
    model."""

    net: str  # NetSpec.name
    hw: str  # HardwareModel.name the plan was derived for
    dtype: str
    input_hw: Tuple[int, int]  # reference (H, W) the plan was derived at
    layers: Tuple[LayerPlan, ...]
    groups: Tuple[FusionGroup, ...] = ()

    def layer_plan(self, idx: int) -> Optional[LayerPlan]:
        for p in self.layers:
            if p.layer == idx:
                return p
        return None

    def algos(self) -> Tuple[str, ...]:
        return tuple(p.algo for p in self.layers)

    def group_of(self, idx: int) -> Optional[FusionGroup]:
        for g in self.groups:
            if idx in g.layers:
                return g
        return None

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": PLAN_VERSION,
                "net": self.net,
                "hw": self.hw,
                "dtype": self.dtype,
                "input_hw": list(self.input_hw),
                "layers": [p.to_dict() for p in self.layers],
                "groups": [g.to_dict() for g in self.groups],
            },
            indent=1,
            sort_keys=True,
        )

    @staticmethod
    def from_json(text: str) -> "NetPlan":
        d = json.loads(text)
        version = d.get("version")
        if version not in _READABLE_VERSIONS:
            raise ValueError(
                f"plan version {version} not in {_READABLE_VERSIONS}"
            )
        # v2 carries no fusion decisions: load with empty groups; callers
        # that want them re-derive via planner.upgrade_plan (same roofline
        # model, so a v2 plan replans identically)
        groups = tuple(
            FusionGroup.from_dict(g) for g in d.get("groups", ())
        )
        return NetPlan(
            net=d["net"],
            hw=d["hw"],
            dtype=d["dtype"],
            input_hw=tuple(d["input_hw"]),
            layers=tuple(LayerPlan.from_dict(l) for l in d["layers"]),
            groups=groups,
        )

    def save(self, path) -> None:
        from repro_torch.core.ioutil import atomic_write_text

        atomic_write_text(pathlib.Path(path), self.to_json())

    @staticmethod
    def load(path) -> "NetPlan":
        return NetPlan.from_json(pathlib.Path(path).read_text())
