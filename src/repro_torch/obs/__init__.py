"""Observability of the port (counterpart of `repro.obs`): the clocks, the
metrics registry and per-query span tracing (docs/OBSERVABILITY.md)."""
from repro_torch.obs.clock import now_s, wall_s
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     merge_snapshots, render_prometheus,
                                     to_json)
from repro_torch.obs.trace import (QueryTrace, SpanRecord, Tracer, activate,
                                   active_traces, get_tracer, span)

__all__ = [
    "now_s", "wall_s",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "merge_snapshots", "render_prometheus", "to_json",
    "QueryTrace", "SpanRecord", "Tracer", "activate", "active_traces",
    "get_tracer", "span",
]
