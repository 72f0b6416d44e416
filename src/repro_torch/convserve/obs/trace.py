"""Flight-recorder spans: a low-overhead, Clock-routed trace ring.

One `Tracer` per serving stack records the full causal chain -- admit
-> queue -> wave formation -> replica dispatch -> per-stage execute ->
tile-engine phases -- as `Span`s (durations) and `InstantEvent`s
(points: faults, scale decisions, adapt verdicts).  Three properties
make it serving-grade:

  * **Clock-routed**: every timestamp comes from the injected `Clock`.
    Under a `SimClock` the whole trace is deterministic -- the same
    seeded run produces the identical span tree, so traces are
    golden-testable, and a simulated fault drill can be replayed span
    by span in Perfetto.
  * **Ring-buffered**: completed events land in a bounded deque; under
    sustained load the recorder holds the most recent `capacity` events
    and counts what it dropped -- it never grows without bound and
    never blocks the serving path on export.
  * **Sampled deterministically**: the `sample_rate` knob keeps every
    Nth *root* span (the counter rule ``int(n*rate) > int((n-1)*rate)``
    -- no RNG, so SimClock determinism survives sampling).  Children
    begun under a dropped root are dropped with it, keeping every
    recorded tree complete.

Cross-thread spans (a wave begins on the dispatch thread and ends on a
replica completion thread) use the explicit `begin()`/`end()` API with
the span id carried by the caller; same-thread nesting uses the
`span()` context manager, which maintains the parent stack in a
thread-local.  Components default to the no-op `NULL_TRACER`, so an
uninstrumented runtime pays one attribute load per site and nothing
else.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# event categories (the span taxonomy; see README "Observability")
CAT_REQUEST = "request"  # admit -> result, one span per rid
CAT_WAVE = "wave"  # dispatch -> completion, one span per wave
CAT_STAGE = "stage"  # one ExecProgram stage's timed execution
CAT_PHASE = "phase"  # tile-engine phase instants (gather/GEMM/...)
CAT_PROFILE = "profile"  # a profile_stages sweep
CAT_FLEET = "fleet"  # replica lifecycle / fault instants
CAT_SCALE = "scale"  # autoscaler decisions
CAT_ADAPT = "adapt"  # replan / shadow / promote / rollback
CAT_ROOFLINE = "roofline"  # per-stage attribution rows as instants

_DROPPED = -1  # stack sentinel: children of a sampled-out root


class Span:
    """One closed duration event.  `flow_in`/`flow_out` carry the flow
    ids the Chrome exporter turns into request->wave->stage arrows."""

    __slots__ = ("sid", "parent", "name", "cat", "t0", "t1", "pid", "tid",
                 "flow_in", "flow_out", "args")

    def __init__(self, sid, parent, name, cat, t0, pid, tid,
                 flow_in, flow_out, args):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t0
        self.pid = pid
        self.tid = tid
        self.flow_in = tuple(flow_in)
        self.flow_out = tuple(flow_out)
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class InstantEvent:
    """One point event."""

    __slots__ = ("name", "cat", "t", "pid", "tid", "args")

    def __init__(self, name, cat, t, pid, tid, args):
        self.name = name
        self.cat = cat
        self.t = t
        self.pid = pid
        self.tid = tid
        self.args = args


class Tracer:
    """The span recorder: a bounded ring of closed events behind one
    lock, timestamps from the injected clock."""

    active = True  # NullTracer overrides: lets callers skip sections

    def __init__(
        self,
        *,
        clock=None,
        capacity: int = 65536,
        sample_rate: float = 1.0,
        enabled: bool = True,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got {sample_rate}")
        if clock is None:
            # deferred: runtime/__init__ imports modules that import us
            from repro_torch.convserve.runtime.clock import RealClock

            clock = RealClock()
        self.clock = clock
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self.enabled = enabled
        self._lock = threading.Lock()
        # the ring: closed spans + instants, oldest evicted first
        self._events = collections.deque(  # guarded-by: _lock
            maxlen=self.capacity
        )
        self._open: Dict[int, Span] = {}  # guarded-by: _lock
        self._next_sid = 1  # guarded-by: _lock
        self._roots_seen = 0  # guarded-by: _lock (sampling counter)
        self._recorded = 0  # guarded-by: _lock
        self._sampled_out = 0  # guarded-by: _lock
        self._tls = threading.local()  # per-thread parent stack + flow hint

    # ------------------------------------------------------ internals

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _keep_root_locked(self) -> bool:
        # holds-lock: _lock
        self._roots_seen += 1
        n, rate = self._roots_seen, self.sample_rate
        return int(n * rate) > int((n - 1) * rate)

    # ------------------------------------------------------ span API

    def begin(
        self,
        name: str,
        cat: str = CAT_REQUEST,
        *,
        parent: Optional[int] = None,
        pid: int = 0,
        tid: int = 0,
        flow_in: Iterable[str] = (),
        flow_out: Iterable[str] = (),
        **args,
    ) -> int:
        """Open a span; returns its id (0 when disabled or sampled out).
        The id is plain data -- `end()` may run on another thread."""
        if not self.enabled:
            return 0
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        if parent == _DROPPED:
            return 0  # child of a sampled-out root: drop the whole tree
        t0 = self.clock.now()
        hint = getattr(self._tls, "flow_hint", None)
        if hint and parent is None:
            flow_in = tuple(flow_in) + (hint,)
        with self._lock:
            if parent is None and not self._keep_root_locked():
                self._sampled_out += 1
                return 0
            sid = self._next_sid
            self._next_sid += 1
            self._open[sid] = Span(
                sid, parent, name, cat, t0, pid, tid, flow_in, flow_out, args
            )
        return sid

    def end(
        self,
        sid: int,
        *,
        pid: Optional[int] = None,
        tid: Optional[int] = None,
        flow_out: Iterable[str] = (),
        **args,
    ) -> None:
        """Close a span by id (no-op for id 0).  Late-binding fields --
        the replica a wave landed on is known only at completion -- may
        be supplied here."""
        if sid <= 0 or not self.enabled:
            return
        t1 = self.clock.now()
        with self._lock:
            span = self._open.pop(sid, None)
            if span is None:
                return
            span.t1 = t1
            if pid is not None:
                span.pid = pid
            if tid is not None:
                span.tid = tid
            if flow_out:
                span.flow_out = span.flow_out + tuple(flow_out)
            if args:
                span.args.update(args)
            self._events.append(span)
            self._recorded += 1

    @contextlib.contextmanager
    def span(self, name: str, cat: str = CAT_REQUEST, **kw):
        """Same-thread nested span: children begun inside parent under
        this tracer on this thread."""
        sid = self.begin(name, cat, **kw)
        stack = self._stack()
        stack.append(sid if sid else _DROPPED)
        try:
            yield sid
        finally:
            stack.pop()
            self.end(sid)

    def instant(
        self, name: str, cat: str = CAT_FLEET, *, pid: int = 0, tid: int = 0,
        **args,
    ) -> None:
        """Record one point event (fault, scale decision, adapt verdict,
        tile phase)."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack and stack[-1] == _DROPPED:
            return
        t = self.clock.now()
        with self._lock:
            self._events.append(InstantEvent(name, cat, t, pid, tid, args))
            self._recorded += 1

    @contextlib.contextmanager
    def flow(self, flow_id: Optional[str]):
        """Attach `flow_id` as a flow-in on every root span begun inside
        (this thread): the runtime brackets a stage profile with the
        latest wave's flow id so traces link wave -> stage."""
        if not flow_id:
            yield
            return
        prev = getattr(self._tls, "flow_hint", None)
        self._tls.flow_hint = flow_id
        try:
            yield
        finally:
            self._tls.flow_hint = prev

    # ------------------------------------------------------- reading

    def events(self) -> List[object]:
        """Snapshot of the ring (closed spans + instants, record order)."""
        with self._lock:
            return list(self._events)

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._open.clear()

    def stats(self) -> dict:
        """The `trace` telemetry section: recorder health counters."""
        with self._lock:
            dropped = max(0, self._recorded - len(self._events))
            return {
                "enabled": self.enabled,
                "sample_rate": self.sample_rate,
                "capacity": self.capacity,
                "recorded": self._recorded,
                "buffered": len(self._events),
                "dropped": dropped,
                "sampled_out": self._sampled_out,
                "open_spans": len(self._open),
            }


class NullTracer:
    """The no-op default: instrumented code pays one method call."""

    active = False
    enabled = False
    sample_rate = 0.0

    def begin(self, *a, **kw) -> int:
        return 0

    def end(self, *a, **kw) -> None:
        return None

    @contextlib.contextmanager
    def span(self, *a, **kw):
        yield 0

    def instant(self, *a, **kw) -> None:
        return None

    @contextlib.contextmanager
    def flow(self, flow_id=None):
        yield

    def events(self) -> list:
        return []

    def open_count(self) -> int:
        return 0

    def clear(self) -> None:
        return None

    def stats(self) -> dict:
        return {"enabled": False}


NULL_TRACER = NullTracer()


@contextlib.contextmanager
def capture_tile_phases(tracer, **extra):
    """Route the tile engine's phase hook into `tracer` for the duration:
    every `conv2d_fused_tile` dispatch inside emits one instant per
    logical phase (gather -> forward GEMM -> mix -> inverse GEMM ->
    scatter) carrying the kernel geometry.  Phases of one fused kernel
    are not separately timeable (they run inside one kernel launch), so
    these fire at dispatch time; the roofline pass splits a stage's
    measured seconds across them by per-phase FLOPs.  Only dispatches on
    the capturing thread announce: replica threads serving meanwhile do
    not."""
    if tracer is None or not getattr(tracer, "enabled", False):
        yield
        return
    from repro_torch.kernels.fused_tile import ops as tile_ops

    owner = threading.get_ident()

    def hook(phase: str, info: dict) -> None:
        if threading.get_ident() == owner:
            tracer.instant(f"phase:{phase}", CAT_PHASE, **info, **extra)

    prev = tile_ops.set_phase_hook(hook)
    try:
        yield
    finally:
        tile_ops.set_phase_hook(prev)


def attach(obj, tracer) -> None:
    """Best-effort: point a pool executor's inner `NetExecutor` at
    `tracer`.  Unwraps the serving onion (`ShardedWaveExecutor.net` ->
    `CompiledNet.executor`); unknown objects are left alone."""
    inner = getattr(obj, "net", obj)  # ShardedWaveExecutor
    inner = getattr(inner, "executor", inner)  # CompiledNet
    if getattr(inner, "tracer", None) is NULL_TRACER:
        inner.tracer = tracer


def span_index(events) -> Dict[int, Span]:
    """sid -> Span over a snapshot (helper for tree assertions)."""
    return {e.sid: e for e in events if isinstance(e, Span)}


def span_tree_signature(events) -> List[Tuple]:
    """A stable, id-free signature of the span forest: (name, cat,
    parent-name-path, t0, t1, pid, tid) per span, sorted.  Two runs of
    the same seeded SimClock workload must produce equal signatures."""
    index = span_index(events)

    def path(span: Span) -> Tuple[str, ...]:
        names: List[str] = []
        cur = span
        seen = set()
        while cur.parent and cur.parent in index and cur.parent not in seen:
            seen.add(cur.parent)
            cur = index[cur.parent]
            names.append(cur.name)
        return tuple(reversed(names))

    return sorted(
        (s.name, s.cat, path(s), round(s.t0, 9), round(s.t1, 9),
         s.pid, s.tid)
        for s in index.values()
    )
