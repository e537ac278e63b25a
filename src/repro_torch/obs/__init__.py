"""Observability: telemetry bus, span tracer, plan attribution, export
(DESIGN.md §13-§14).

The serve runtime, train loop, planner, collectives and the kernel block
autotuner record counters, gauges, latency reservoirs and events on the
`Telemetry` bus; the online controller (`repro_torch.pm.controller`) consumes
the same records to adapt runtime knobs — one signal path instead of
ad-hoc prints and scattered result fields.

Above the bus: `SpanTracer` (ring-buffered per-request/per-phase spans,
Chrome-trace export), `PlanAttribution` (plan-vs-actual accounting at
replan boundaries), `prometheus_text`/`JsonlSink` (scrape/file export),
and ``python -m repro_torch.obs.report`` (the shutdown report renderer).
"""

from repro_torch.obs.attribution import (ATTRIBUTION_SCHEMA, AttributionRecord,
                                   PlanAttribution)
from repro_torch.obs.export import (SCHEMA_VERSION, JsonlSink, prometheus_text,
                              read_jsonl)
from repro_torch.obs.telemetry import (Counter, Gauge, Reservoir, Telemetry,
                                 default_bus, json_safe)
from repro_torch.obs.trace import SpanTracer, make_tracer

__all__ = [
    "ATTRIBUTION_SCHEMA", "AttributionRecord", "Counter", "Gauge",
    "JsonlSink", "PlanAttribution", "Reservoir", "SCHEMA_VERSION",
    "SpanTracer", "Telemetry", "default_bus", "json_safe", "make_tracer",
    "prometheus_text", "read_jsonl",
]
