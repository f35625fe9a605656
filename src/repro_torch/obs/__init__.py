"""Observability layer: span tracing, unified counters, Perfetto export.

* :mod:`repro_torch.obs.tracer` — nested timed spans with attributes; a
  shared no-op tracer (:data:`NOOP`) is the default everywhere.
* :mod:`repro_torch.obs.metrics` — the unified counter schema
  (``name, unit, per_worker[], total``) plus converters from the
  counter families (engine stats, TruncationReport).
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON (Perfetto) from
  simulator traces, tracer spans and mesh runs; compact text report.
"""
from .tracer import NOOP, NoopTracer, Span, Tracer, as_tracer
from .metrics import (Counter, MetricSet, SCHEMA_VERSION, from_engine_stats,
                      from_sim_report, from_truncation, validate_metrics)
from .export import (chrome_trace, mesh_stats_events, sim_trace_events,
                     span_events, text_report, write_chrome_trace)

__all__ = [
    "NOOP", "NoopTracer", "Span", "Tracer", "as_tracer",
    "Counter", "MetricSet", "SCHEMA_VERSION", "from_engine_stats",
    "from_sim_report", "from_truncation", "validate_metrics",
    "chrome_trace", "mesh_stats_events", "sim_trace_events",
    "span_events", "text_report", "write_chrome_trace",
]
