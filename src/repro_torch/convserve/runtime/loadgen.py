"""Seeded open-loop traffic generators for the serving runtime.

Open-loop means arrival times are drawn up front and never react to the
server (the standard methodology for tail-latency measurement --
closed-loop clients hide queueing delay by slowing down with the
server, the "coordinated omission" trap).  Every generator takes a seed
and returns a plain list of `Arrival`s, so a trace replays identically
against the real clock, the simulated clock, and across the fused /
unfused A-B runs of the benchmark.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.convserve.runtime.queueing import STANDARD


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request's schedule: when it arrives and what it looks like."""

    t: float  # seconds from trace start
    rid: int
    h: int
    w: int
    priority: int = STANDARD
    deadline_s: Optional[float] = None  # relative completion deadline


def _draw(
    rng: np.random.Generator,
    times: Sequence[float],
    sizes: Sequence[int],
    priorities: Sequence[int],
    deadline_s: Optional[float],
) -> List[Arrival]:
    out = []
    for rid, t in enumerate(times):
        side = int(rng.choice(np.asarray(sizes)))
        out.append(
            Arrival(
                t=float(t), rid=rid, h=side, w=side,
                priority=int(rng.choice(np.asarray(priorities))),
                deadline_s=deadline_s,
            )
        )
    return out


def poisson_trace(
    rate_hz: float,
    n: int,
    *,
    seed: int,
    sizes: Sequence[int] = (64,),
    priorities: Sequence[int] = (STANDARD,),
    deadline_s: Optional[float] = None,
) -> List[Arrival]:
    """`n` arrivals with exponential inter-arrival times at `rate_hz`."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    return _draw(rng, times, sizes, priorities, deadline_s)


def burst_trace(
    n: int,
    *,
    burst: int,
    period_s: float,
    seed: int,
    sizes: Sequence[int] = (64,),
    priorities: Sequence[int] = (STANDARD,),
    deadline_s: Optional[float] = None,
) -> List[Arrival]:
    """`burst` simultaneous arrivals every `period_s` (flash-crowd
    traffic: exercises admission control and partial-wave flushes)."""
    rng = np.random.default_rng(seed)
    times = [(i // burst) * period_s for i in range(n)]
    return _draw(rng, times, sizes, priorities, deadline_s)


def diurnal_rate(
    mean_rate_hz: float,
    *,
    depth: float = 0.8,
    period_s: float = 86400.0,
    phase_s: float = 0.0,
) -> Callable[[float], float]:
    """Sinusoidal rate profile: the trough sits at ``t = phase_s`` (the
    simulated day starts at night) and the peak half a period later.
    ``depth`` in [0, 1) scales the swing around `mean_rate_hz`."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")

    def rate(t: float) -> float:
        return mean_rate_hz * (
            1.0 - depth * math.cos(2.0 * math.pi * (t - phase_s) / period_s)
        )

    return rate


def diurnal_trace(
    mean_rate_hz: float,
    n: int,
    *,
    seed: int,
    depth: float = 0.8,
    period_s: float = 86400.0,
    phase_s: float = 0.0,
    sizes: Sequence[int] = (64,),
    priorities: Sequence[int] = (STANDARD,),
    deadline_s: Optional[float] = None,
) -> List[Arrival]:
    """`n` arrivals from a non-homogeneous Poisson process whose rate
    follows `diurnal_rate` -- the "million-user day" shape: quiet night,
    busy noon.  Drawn by Lewis-Shedlock thinning against the peak rate,
    so the arrivals are exactly Poisson at every instant and the whole
    trace is reproducible from the seed.  Compose with `burst_trace`
    (flash crowd on top of the daily curve) via `merge_traces`."""
    rng = np.random.default_rng(seed)
    rate = diurnal_rate(
        mean_rate_hz, depth=depth, period_s=period_s, phase_s=phase_s
    )
    peak = mean_rate_hz * (1.0 + depth)
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / peak)
        if rng.uniform() * peak <= rate(t):
            times.append(t)
    return _draw(rng, times, sizes, priorities, deadline_s)


def merge_traces(*traces: Sequence[Arrival]) -> List[Arrival]:
    """Superimpose traces (diurnal baseline + flash-crowd bursts + ...)
    into one arrival-ordered trace with dense, collision-free rids.
    Priorities, sizes, and deadlines ride through unchanged; only the
    rids are re-assigned (in arrival order), so `make_images` on the
    merged trace keys every request correctly."""
    merged = sorted(
        (a for trace in traces for a in trace), key=lambda a: (a.t, a.rid)
    )
    return [
        dataclasses.replace(a, rid=i) for i, a in enumerate(merged)
    ]


def make_images(
    trace: Sequence[Arrival], c: int, *, seed: int, scale: float = 0.1
) -> Dict[int, np.ndarray]:
    """Seeded HWC images matching a trace, keyed by rid."""
    rng = np.random.default_rng(seed)
    return {
        a.rid: (rng.standard_normal((a.h, a.w, c)) * scale).astype(
            np.float32
        )
        for a in trace
    }
