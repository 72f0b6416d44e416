"""Trace exporters: Chrome/Perfetto JSON, Prometheus text, FlightRecorder.

The Chrome trace event format is the interchange surface: a JSON array
of events (`ph: "X"` complete spans, `"i"` instants, `"s"`/`"f"` flow
pairs) that loads directly in Perfetto / chrome://tracing.  `pid` is
the replica, `tid` the shard, and flow arrows link a request span to
the wave that served it and the wave to the stage executions it timed.

`FlightRecorder` is the black box: it watches for the three "something
went visibly wrong" signals -- an SLO breach, a `WaveLoss`, a
`VerificationError` -- and dumps the tracer's ring buffer (plus the
telemetry snapshot, when given one) to a `.trace.json` the moment one
fires, throttled to `max_dumps` per incident class so a loss storm
cannot fill the disk.
"""

from __future__ import annotations

import json
import threading
from typing import List, Optional

from repro_torch.convserve.obs.trace import InstantEvent, Span

_US = 1e6  # Clock seconds -> trace microseconds


def chrome_trace_events(events, *, process_names=None) -> List[dict]:
    """Render a ring snapshot as a Chrome trace event array.

    Flow links: a span carrying ``flow_out`` ids emits a flow *start*
    (``"s"``) at its close; a span carrying ``flow_in`` ids emits the
    matching flow *finish* (``"f"``, ``bp: "e"``) at its open.  Chrome
    draws one arrow per id from every start to every finish, which is
    exactly request -> wave -> stage.  Only flows with BOTH ends in the
    ring are emitted: every wave advertises its flow id at close, but
    only the profiled wave gains a stage-side consumer, and a dangling
    half-arrow is exporter noise, not information.
    """
    out: List[dict] = []
    flow_ids = {}  # flow string -> stable small int

    def fid(flow: str) -> int:
        return flow_ids.setdefault(flow, len(flow_ids) + 1)

    starts = {f for e in events if isinstance(e, Span) for f in e.flow_out}
    ends = {f for e in events if isinstance(e, Span) for f in e.flow_in}
    live_flows = starts & ends

    for e in events:
        if isinstance(e, Span):
            out.append({
                "ph": "X",
                "name": e.name,
                "cat": e.cat,
                "ts": e.t0 * _US,
                "dur": max(0.0, e.dur) * _US,
                "pid": e.pid,
                "tid": e.tid,
                "args": dict(e.args),
            })
            for flow in e.flow_in:
                if flow in live_flows:
                    out.append({
                        "ph": "f", "bp": "e", "name": flow, "cat": e.cat,
                        "id": fid(flow), "ts": e.t0 * _US,
                        "pid": e.pid, "tid": e.tid,
                    })
            for flow in e.flow_out:
                if flow in live_flows:
                    out.append({
                        "ph": "s", "name": flow, "cat": e.cat,
                        "id": fid(flow), "ts": e.t1 * _US,
                        "pid": e.pid, "tid": e.tid,
                    })
        elif isinstance(e, InstantEvent):
            out.append({
                "ph": "i",
                "name": e.name,
                "cat": e.cat,
                "ts": e.t * _US,
                "pid": e.pid,
                "tid": e.tid,
                "s": "p",  # process-scoped instant
                "args": dict(e.args),
            })
    if process_names:
        for pid, name in process_names.items():
            out.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name},
            })
    return out


def validate_chrome_trace(data) -> List[str]:
    """Structural validation of an exported trace; returns problems
    (empty list == valid).  Checks the acceptance-criteria invariants:
    loads as an event array, every duration event is well-formed and
    non-negative, and every flow id has both a start and a finish."""
    problems: List[str] = []
    if not isinstance(data, list):
        return [f"trace is {type(data).__name__}, expected a JSON array"]
    starts, finishes = set(), set()
    for i, e in enumerate(data):
        if not isinstance(e, dict) or "ph" not in e:
            problems.append(f"event {i}: not an event object")
            continue
        ph = e["ph"]
        if ph in ("X", "i", "s", "f") and "name" not in e:
            problems.append(f"event {i}: ph={ph} missing name")
        if ph == "X":
            if "dur" not in e or "ts" not in e:
                problems.append(f"event {i}: complete event missing ts/dur")
            elif e["dur"] < 0:
                problems.append(f"event {i}: negative duration {e['dur']}")
        elif ph == "s":
            starts.add(e.get("id"))
        elif ph == "f":
            finishes.add(e.get("id"))
    for fid in sorted(starts - finishes, key=str):
        problems.append(f"flow id {fid}: start without finish")
    for fid in sorted(finishes - starts, key=str):
        problems.append(f"flow id {fid}: finish without start")
    return problems


def write_trace(tracer, path, *, process_names=None, extra_events=()) -> int:
    """Dump the tracer's ring as Chrome-trace JSON; returns the event
    count written."""
    events = chrome_trace_events(tracer.events(), process_names=process_names)
    events.extend(extra_events)
    with open(path, "w") as f:
        json.dump(events, f)
    return len(events)


def _prom_name(name: str) -> str:
    out = [c if c.isalnum() or c == "_" else "_" for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def prometheus_text(snapshot: dict, *, prefix: str = "convserve") -> str:
    """Render a `Telemetry.snapshot()` document in the Prometheus text
    exposition format (counters, gauges, and latency quantiles)."""
    lines: List[str] = []
    for name, val in sorted(snapshot.get("counters", {}).items()):
        m = f"{prefix}_{_prom_name(name)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {val}")
    for name, val in sorted(snapshot.get("gauges", {}).items()):
        m = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {val}")
    for name, h in sorted(snapshot.get("latency", {}).items()):
        m = f"{prefix}_{_prom_name(name)}_seconds"
        lines.append(f"# TYPE {m} summary")
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"), ("0.99", "p99_s")):
            if key in h:
                lines.append(f'{m}{{quantile="{q}"}} {h[key]}')
        if "count" in h:
            lines.append(f"{m}_count {h['count']}")
        if "count" in h and "mean_s" in h:
            lines.append(f"{m}_sum {h['count'] * h['mean_s']}")
    return "\n".join(lines) + "\n"


# the signals a flight recorder dumps on
TRIP_SLO_BREACH = "slo_breach"
TRIP_WAVE_LOSS = "wave_loss"
TRIP_VERIFICATION = "verification_error"


class FlightRecorder:
    """Dump the ring buffer when the serving stack visibly misbehaves.

    `trip(reason)` is called by the runtime on an SLO breach (deadline
    miss), a `WaveLoss`, or a `VerificationError`; each distinct reason
    gets at most `max_dumps` dumps, written as
    ``{path_prefix}.{reason}.{n}.trace.json``.  A disabled recorder
    (``path_prefix=None``) only counts trips -- useful in tests and in
    benches that want the counters without the files.
    """

    def __init__(
        self,
        tracer,
        *,
        telemetry=None,
        path_prefix: Optional[str] = None,
        max_dumps: int = 3,
    ):
        self.tracer = tracer
        self.telemetry = telemetry
        self.path_prefix = path_prefix
        self.max_dumps = int(max_dumps)
        self._lock = threading.Lock()
        self._trips = {}  # guarded-by: _lock (reason -> trip count)
        self._dumps: List[str] = []  # guarded-by: _lock (paths written)

    def trip(self, reason: str, **detail) -> Optional[str]:
        """Record an incident; dump the ring if this reason still has
        dump budget.  Returns the path written, or None."""
        with self._lock:
            n = self._trips.get(reason, 0) + 1
            self._trips[reason] = n
            want_dump = self.path_prefix is not None and n <= self.max_dumps
            path = (
                f"{self.path_prefix}.{reason}.{n}.trace.json"
                if want_dump else None
            )
        self.tracer.instant(
            "flight.trip", "fleet", reason=reason, dumped=bool(path), **detail
        )
        if self.telemetry is not None:
            self.telemetry.inc(f"flight.trip.{reason}")
        if path is not None:
            extra = ()
            if self.telemetry is not None:
                extra = ({
                    "ph": "M", "name": "telemetry", "pid": 0, "tid": 0,
                    "args": json.loads(self.telemetry.to_json()),
                },)
            write_trace(self.tracer, path, extra_events=extra)
            with self._lock:
                self._dumps.append(path)
        return path

    def guard(self, reason: str = TRIP_VERIFICATION):
        """Context manager: trip on `VerificationError` (re-raised)."""
        return _RecorderGuard(self, reason)

    def stats(self) -> dict:
        with self._lock:
            return {
                "trips": dict(self._trips),
                "dumps": list(self._dumps),
                "max_dumps": self.max_dumps,
            }


class _RecorderGuard:
    def __init__(self, recorder: FlightRecorder, reason: str):
        self.recorder = recorder
        self.reason = reason

    def __enter__(self):
        return self.recorder

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            from repro_torch.convserve.check.diagnostics import VerificationError

            if isinstance(exc, VerificationError):
                self.recorder.trip(self.reason, error=str(exc)[:200])
        return False


def roofline_table(rows, *, hw_name: str = "") -> str:
    """Human-readable measured-vs-ceiling table from roofline rows (the
    dicts of `obs.roofline.attribute_program` / a BENCH ``roofline``
    section / ``roofline.stage`` trace instants)."""
    head = (
        f"{'stage':<14} {'level':<12} {'meas us':>9} {'pred us':>9} "
        f"{'GFLOP/s':>9} {'roof':>9} {'frac':>6}  verdict"
    )
    lines = [f"roofline attribution{' on ' + hw_name if hw_name else ''}",
             head, "-" * len(head)]
    for r in rows:
        pred = r.get("predicted_us")
        lines.append(
            f"{r['stage']:<14} {r['binding_level']:<12} "
            f"{r['measured_us']:>9.1f} "
            f"{(f'{pred:.1f}' if pred is not None else '-'):>9} "
            f"{r['achieved_gflops']:>9.2f} {r['roof_gflops']:>9.2f} "
            f"{r['frac_of_roof']:>6.3f}  {r['verdict']}"
        )
        for ph in r.get("phases") or ():
            lines.append(
                f"  · {ph['phase']:<11} {'':<12} "
                f"{ph['attributed_us']:>9.1f} {'':>9} {'':>9} {'':>9} "
                f"{ph['macs_frac']:>6.3f}"
            )
    return "\n".join(lines)
