"""Observability layer: span tracing and unified counters.

* :mod:`repro_torch.obs.tracer` — nested timed spans with attributes; a
  shared no-op tracer (:data:`NOOP`) is the default everywhere.
* :mod:`repro_torch.obs.metrics` — the unified counter schema
  (``name, unit, per_worker[], total``) plus converters from the
  counter families (engine stats, TruncationReport).

The Perfetto export (``obs/export.py`` in the reference) is not ported yet
(ROADMAP.md, queue 1).
"""
from .tracer import NOOP, NoopTracer, Span, Tracer, as_tracer
from .metrics import (Counter, MetricSet, SCHEMA_VERSION, from_engine_stats,
                      from_sim_report, from_truncation, validate_metrics)

__all__ = [
    "NOOP", "NoopTracer", "Span", "Tracer", "as_tracer",
    "Counter", "MetricSet", "SCHEMA_VERSION", "from_engine_stats",
    "from_sim_report", "from_truncation", "validate_metrics",
]
