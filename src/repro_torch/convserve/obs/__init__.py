"""convserve.obs: flight-recorder tracing + live roofline attribution.

`trace` is the span recorder (Clock-routed, ring-buffered, sampled);
`export` turns a ring into Chrome/Perfetto JSON, Prometheus text, or a
FlightRecorder crash dump.  `roofline` (imported explicitly -- it pulls
in the planner) joins measured stage seconds with TileAlgebra terms and
HardwareModel ceilings.
"""

from repro_torch.convserve.obs.export import (
    FlightRecorder,
    TRIP_SLO_BREACH,
    TRIP_VERIFICATION,
    TRIP_WAVE_LOSS,
    chrome_trace_events,
    prometheus_text,
    roofline_table,
    validate_chrome_trace,
    write_trace,
)
from repro_torch.convserve.obs.trace import (
    CAT_ADAPT,
    CAT_FLEET,
    CAT_PHASE,
    CAT_PROFILE,
    CAT_REQUEST,
    CAT_ROOFLINE,
    CAT_SCALE,
    CAT_STAGE,
    CAT_WAVE,
    InstantEvent,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    attach,
    capture_tile_phases,
    span_index,
    span_tree_signature,
)

__all__ = [
    "CAT_ADAPT", "CAT_FLEET", "CAT_PHASE", "CAT_PROFILE", "CAT_REQUEST",
    "CAT_ROOFLINE", "CAT_SCALE", "CAT_STAGE", "CAT_WAVE",
    "FlightRecorder", "InstantEvent", "NULL_TRACER", "NullTracer", "Span",
    "TRIP_SLO_BREACH", "TRIP_VERIFICATION", "TRIP_WAVE_LOSS", "Tracer",
    "attach", "capture_tile_phases", "chrome_trace_events",
    "prometheus_text", "roofline_table", "span_index",
    "span_tree_signature", "validate_chrome_trace", "write_trace",
]
