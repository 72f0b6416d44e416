"""Measured-cost wisdom store: the adapt loop's memory.

Entries are keyed the same way `tune.py` wisdom is keyed --
``backend:family:geometry``, with the tune wisdom's backend prefix
(``torch-cuda`` / ``torch-cpu``) -- so a measurement taken for one
executor transfers to any plan that poses the same (algorithm, ConvSpec)
question on the same kind of device, and an FFT measurement can never
shadow a Winograd one:

    torch-cuda:fft_fused:48x48x4->8:k3:s1:g1              (single stage)
    torch-cuda:group[fft_fused+fft_fused]:48x48x4->8:...  (fused group stage)

Values are EWMA-smoothed measured seconds together with the roofline
prediction for the same stage, stamped with a monotonic generation and
a clock timestamp (the stamps `tune.py` entries carry); `lookup` and
`entry` read an entry too old or of too early a generation as absent.  Cold
(compile-inclusive) observations are excluded from the EWMA -- they are
counted, because a store that silently drops data is a store you cannot
debug.

`MeasuredCostStore` is also the `costs=` view the planner consumes
(`plan_net(..., costs=store)`): `algo_time_s` answers the per-layer
override and `group_time_s` the fusion verdict, both None when the
geometry has never been measured (the planner then falls back to the
analytic model -- measurement only ever *narrows* the model, never
invents numbers).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import threading
from typing import Dict, Optional, Sequence

from repro_torch.core import registry, tune
from repro_torch.core.device import DeviceLike


def layer_key(algo: str, spec: registry.ConvSpec, backend=None) -> str:
    """Measured-cost key for one (algorithm, geometry) -- mirrors
    `tune._key`'s backend:family:geometry shape (default backend: where
    this process runs by default, as `tune` keys it)."""
    backend = backend or tune._backend()
    return (
        f"{backend}:{algo}:{spec.h}x{spec.w}x{spec.c_in}->{spec.c_out}"
        f":k{spec.k}:s{spec.stride}:g{spec.groups}"
    )


def group_key(members: Sequence, backend=None) -> str:
    """Measured-cost key for a fused group stage: the member algorithms
    plus the group's input geometry and the per-member channel chain
    (enough to distinguish any two groups a planner can form)."""
    backend = backend or tune._backend()
    algos = "+".join(p.algo for p in members)
    first = members[0].spec
    chain = "->".join(
        [str(first.c_in)] + [str(p.spec.c_out) for p in members]
    )
    return (
        f"{backend}:group[{algos}]:{first.h}x{first.w}x{chain}"
        f":k{'+'.join(str(p.spec.k) for p in members)}"
    )


def stage_key(stage, backend=None) -> str:
    """Key for an ExecProgram stage: group key when fused, else the
    single unit's layer key."""
    plans = [u.plan for u in stage.units]
    if stage.fused:
        return group_key(plans, backend=backend)
    return layer_key(plans[0].algo, plans[0].spec, backend=backend)


@dataclasses.dataclass
class CostEntry:
    """One measured geometry: EWMA seconds + the roofline's prediction
    for the same stage, generation/timestamp stamped."""

    measured_s: float
    predicted_s: Optional[float]
    n: int
    gen: int
    ts: float

    @property
    def ratio(self) -> Optional[float]:
        """measured / predicted -- the divergence currency."""
        if not self.predicted_s or self.predicted_s <= 0:
            return None
        return self.measured_s / self.predicted_s


class MeasuredCostStore:
    """EWMA store of measured stage times, usable as the planner's
    `costs=` view.  Thread-safe: telemetry taps observe from replica
    threads while the replanner reads.  `device` names where the
    measurements are taken (their keys' backend prefix; default: where
    this process runs by default)."""

    def __init__(self, *, ewma: float = 0.3, clock=None,
                 device: DeviceLike = None):
        if not 0 < ewma <= 1:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.ewma = ewma
        self.backend = tune._backend(device)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[str, CostEntry] = {}  # guarded-by: _lock
        self._gen = 0  # guarded-by: _lock
        self.cold_skipped = 0  # guarded-by: _lock

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else 0.0

    # ------------------------------------------------------- writes

    def observe(
        self,
        key: str,
        measured_s: float,
        *,
        predicted_s: Optional[float] = None,
        cold: bool = False,
        now: Optional[float] = None,
    ) -> None:
        """Fold one measurement into the EWMA for `key`.  Cold (compile-
        inclusive) samples are excluded -- they would poison the EWMA
        with one-time jit cost -- but counted in `cold_skipped`."""
        if cold:
            with self._lock:
                self.cold_skipped += 1
            return
        now = self._now() if now is None else now
        with self._lock:
            self._gen += 1
            prev = self._entries.get(key)
            if prev is None:
                self._entries[key] = CostEntry(
                    measured_s=float(measured_s),
                    predicted_s=predicted_s,
                    n=1, gen=self._gen, ts=now,
                )
            else:
                a = self.ewma
                self._entries[key] = CostEntry(
                    measured_s=(1 - a) * prev.measured_s + a * float(measured_s),
                    predicted_s=(
                        predicted_s if predicted_s is not None
                        else prev.predicted_s
                    ),
                    n=prev.n + 1, gen=self._gen, ts=now,
                )

    # -------------------------------------------------------- reads

    def entry(
        self,
        key: str,
        *,
        max_age_s: Optional[float] = None,
        min_gen: int = 0,
        now: Optional[float] = None,
    ) -> Optional[CostEntry]:
        with self._lock:
            e = self._entries.get(key)
        if e is None or e.gen < min_gen:
            return None
        if max_age_s is not None:
            now = self._now() if now is None else now
            if e.ts < now - max_age_s:
                return None
        return e

    def lookup(self, key: str, **kw) -> Optional[float]:
        e = self.entry(key, **kw)
        return e.measured_s if e is not None else None

    def ratio_scale(self) -> float:
        """Median measured/predicted ratio across every entry that has a
        prediction.  The divergence monitor judges each stage's ratio
        RELATIVE to this scale, so a uniformly mis-calibrated peak-FLOPs
        constant (every stage 5x slower than modeled) reads as zero
        divergence while one pathological stage stands out."""
        with self._lock:
            ratios = [
                e.ratio for e in self._entries.values()
                if e.ratio is not None
            ]
        return statistics.median(ratios) if ratios else 1.0

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------- the planner's `costs=` view

    def algo_time_s(
        self, algo: str, spec: registry.ConvSpec
    ) -> Optional[float]:
        """Measured single-stage seconds for (algo, geometry), else None."""
        return self.lookup(layer_key(algo, spec, self.backend))

    def group_time_s(self, members: Sequence) -> Optional[float]:
        """Measured fused-group seconds for these member plans, else None."""
        return self.lookup(group_key(members, self.backend))

    # ------------------------------------------------------- persist

    def to_json(self) -> dict:
        with self._lock:
            return {
                k: dataclasses.asdict(e) for k, e in self._entries.items()
            }

    def save(self, path) -> None:
        from repro_torch.core.ioutil import atomic_write_text

        atomic_write_text(path, json.dumps(self.to_json(), indent=1,
                                           sort_keys=True))

    @classmethod
    def load(cls, path, **kw) -> "MeasuredCostStore":
        store = cls(**kw)
        with open(path) as f:
            raw = json.load(f)
        with store._lock:
            for k, v in raw.items():
                store._entries[k] = CostEntry(**v)
                store._gen = max(store._gen, int(v.get("gen", 0)))
        return store
