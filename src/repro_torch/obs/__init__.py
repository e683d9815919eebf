"""Observability for the port: metrics, request tracing, exporters (port
of repro/obs/, with the reference's metric names, label sets, JSONL
event schema and ``REPRO_OBS_JSONL`` variable).

Everything here is host-side Python. Engines bump counters and open
spans outside any captured CUDA graph; the one bump that runs while a
graph is prepared (the compile-count spy) runs once per preparation and
never under replay, the meaning the reference's trace-time bump has.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    default_registry,
)
from repro_torch.obs.trace import NullTracer, Span, Tracer
from repro_torch.obs.obs import Observability
from repro_torch.obs.export import (
    json_snapshot,
    parse_prometheus_text,
    prometheus_text,
    write_json_snapshot,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NullTracer",
    "Observability",
    "Span",
    "Tracer",
    "default_registry",
    "json_snapshot",
    "parse_prometheus_text",
    "prometheus_text",
    "write_json_snapshot",
]
