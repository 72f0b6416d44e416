"""Metrics registry for the serving runtime.

One thread-safe `Telemetry` object per runtime: monotonic counters
(waves, rejects, deadline misses), gauges (queue depth, in-flight),
and log-bucketed latency histograms (queue wait / compute / end-to-end)
with p50/p95/p99 estimation.  `snapshot()` rolls everything -- plus the
caller-supplied sections like kernel-cache counters and per-stage
profiles -- into ONE plain-JSON document, the single artifact the
benchmarks write and dashboards would scrape.

Histograms are fixed log-spaced buckets, not reservoirs: recording is
O(1) and allocation-free under load, and the percentile error is
bounded by the bucket ratio (~12% with the default 2**(1/4) spacing),
tight enough for tail-latency tracking.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional


class Histogram:
    """Log-spaced latency histogram over (lo_s, hi_s)."""

    def __init__(
        self, lo_s: float = 1e-6, hi_s: float = 1e3, ratio: float = 2 ** 0.25
    ):
        self._lo = lo_s
        self._ratio = ratio
        self._log_ratio = math.log(ratio)
        n = int(math.ceil(math.log(hi_s / lo_s) / self._log_ratio)) + 1
        self._counts = [0] * (n + 2)  # +underflow, +overflow
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def _bucket(self, v: float) -> int:
        if v < self._lo:
            return 0
        i = int(math.log(v / self._lo) / self._log_ratio) + 1
        return min(i, len(self._counts) - 1)

    def record(self, seconds: float) -> None:
        self._counts[self._bucket(seconds)] += 1
        self.count += 1
        self.total += seconds
        self.max = max(self.max, seconds)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-quantile (0 < p <= 1),
        clamped to the observed max."""
        if self.count == 0:
            return 0.0
        target = p * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                if i == 0:
                    return min(self._lo, self.max)
                return min(self._lo * self._ratio ** i, self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "p50_s": self.percentile(0.50),
            "p95_s": self.percentile(0.95),
            "p99_s": self.percentile(0.99),
            "max_s": self.max,
        }


class Telemetry:
    """Counters + gauges + named histograms behind one lock (histogram
    recording happens on replica completion threads).

    Every mutation bumps a monotonic sequence number, and `snapshot()`
    stamps the document with it (plus the injected clock's time) under
    a ``meta`` section.  Consumers that make decisions from snapshots --
    the autoscaler, the adapt controller -- compare the stamp against
    the live `stamp()` to detect that they are acting on stale data.
    """

    def __init__(self, *, clock=None):
        self._lock = threading.Lock()
        self._clock = clock  # None = unstamped times (seq still works)
        self._seq = 0  # guarded-by: _lock (bumps on every mutation)
        self._mut_t: Optional[float] = None  # guarded-by: _lock
        self._counters: Dict[str, int] = {}  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}  # guarded-by: _lock
        self._hists: Dict[str, Histogram] = {}  # guarded-by: _lock

    def _touch_locked(self) -> None:
        # holds-lock: _lock
        self._seq += 1
        if self._clock is not None:
            self._mut_t = self._clock.now()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._touch_locked()
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._touch_locked()
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._touch_locked()
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.record(seconds)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def stamp(self) -> dict:
        """The live freshness stamp: ``{"seq", "t"}``.  `seq` increments
        on every mutation; `t` is the clock time of the LAST mutation
        (None without an injected clock, or before any mutation) -- so
        ``now - t`` is the snapshot's data age."""
        with self._lock:
            return self._stamp_locked()

    def _stamp_locked(self) -> dict:
        # holds-lock: _lock
        return {"seq": self._seq, "t": self._mut_t}

    def snapshot(self, **sections) -> dict:
        """The one JSON document: counters, gauges, latency percentiles,
        plus any extra sections (scheduler/pool/cache/stage rollups)
        merged in by name.  Always JSON-serializable.  The ``meta``
        section carries the freshness stamp taken atomically with the
        counter/gauge/latency read."""
        with self._lock:
            doc = {
                "meta": self._stamp_locked(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "latency": {k: h.snapshot() for k, h in self._hists.items()},
            }
        for name, section in sections.items():
            if section is not None:
                doc[name] = section
        json.dumps(doc)  # refuse to return a non-serializable document
        return doc

    def to_json(self, **sections) -> str:
        return json.dumps(self.snapshot(**sections), indent=1, sort_keys=True)


def stage_rollup(profile: List[tuple]) -> List[dict]:
    """`NetExecutor.profile_stages` rows -> JSON-able per-stage rollup."""
    return [{"label": label, "us": secs * 1e6} for label, secs in profile]
