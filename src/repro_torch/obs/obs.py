"""The per-component observability bundle: one registry + one tracer
(port of repro/obs/obs.py).

Each engine/manager owns an ``Observability`` (isolated counters, so
``engine.obs.metrics.value("msda_compiles_total", ...)`` is exact for
that engine); ``Observability.disabled()`` is the measurably-zero-cost
uninstrumented mode used by the overhead benchmark.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry, NullRegistry
from repro_torch.obs.trace import NullTracer, Tracer

# Environment switch: when set, engines created with obs=None log their
# span/plan/metrics events to this JSONL path (the reference's variable).
OBS_JSONL_ENV = "REPRO_OBS_JSONL"


class Observability:
    def __init__(self, metrics: MetricsRegistry, tracer: Tracer) -> None:
        self.metrics = metrics
        self.tracer = tracer

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled

    @classmethod
    def create(cls, jsonl_path: Optional[str] = None,
               capacity: int = 4096,
               profiler_annotations: bool = False) -> "Observability":
        return cls(MetricsRegistry(),
                   Tracer(capacity=capacity, jsonl_path=jsonl_path,
                          profiler_annotations=profiler_annotations))

    @classmethod
    def default(cls, capacity: int = 4096) -> "Observability":
        """What engines build when constructed with ``obs=None``:
        enabled metrics + tracer, JSONL sink iff REPRO_OBS_JSONL is set."""
        return cls.create(jsonl_path=os.environ.get(OBS_JSONL_ENV) or None,
                          capacity=capacity)

    @classmethod
    def disabled(cls) -> "Observability":
        return cls(NullRegistry(), NullTracer())

    def flush_metrics(self) -> None:
        """Write a metrics snapshot event into the JSONL log (dashboard
        refresh point).  No-op without a sink."""
        self.tracer.event("metrics", wall_time=time.time(),
                          data=self.metrics.snapshot())

    def close(self) -> None:
        self.tracer.close()
