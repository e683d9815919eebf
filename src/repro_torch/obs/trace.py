"""Per-request span tracing: bounded ring buffer + optional JSONL log
(port of repro/obs/trace.py; the event-log schema is the reference's).

A *span* is a named, timed interval attached to a request id. The serve
engine opens spans across threads (``queue`` starts on the submit
thread, ``postproc`` ends on the worker thread), so ``start`` returns an
opaque span id and ``end`` may be called from anywhere. Single-thread
scopes use the ``span(...)`` context manager, which with
``profiler_annotations=True`` also opens a
``torch.profiler.record_function(name)`` so that the span shows in a
``torch.profiler`` trace beside the card's kernels.

All timestamps are ``time.perf_counter()`` — monotonic by contract.
``end`` refuses a negative-duration span with ``ValueError`` instead of
silently corrupting percentiles (callers may inject explicit
timestamps, e.g. replaying a log, which is where the check earns its
keep).

Event-log schema (one JSON object per line)::

    {"type": "span_start", "span": "t1-3", "name": "queue",
     "rid": 7, "t": 123.4, ...attrs}
    {"type": "span_end",   "span": "t1-3", "name": "queue",
     "rid": 7, "t": 123.9, "dur_s": 0.5, ...attrs}
    {"type": "plan" | "metrics" | ..., "t": 124.0, ...payload}

The validator (``python -m repro_torch.obs.validate``) asserts every
span in a log is well-formed: paired start/end, non-negative duration.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

_tracer_ids = itertools.count(1)


@dataclass
class Span:
    span_id: str
    name: str
    rid: Optional[object] = None
    t0: float = 0.0
    t1: Optional[float] = None
    attrs: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else float("nan")

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "name": self.name, "rid": self.rid,
                "t0": self.t0, "t1": self.t1,
                "dur_s": self.duration_s, **self.attrs}


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Tracer:
    """Span recorder with a bounded ring buffer and optional JSONL sink."""

    enabled = True

    def __init__(self, capacity: int = 4096,
                 jsonl_path: Optional[str] = None,
                 profiler_annotations: bool = False) -> None:
        self._prefix = f"t{next(_tracer_ids)}"
        self._seq = itertools.count(1)
        self._open: Dict[str, Span] = {}
        self._lock = threading.Lock()
        self.spans: Deque[Span] = collections.deque(maxlen=capacity)
        self.jsonl_path = jsonl_path
        self._sink = None
        self.profiler_annotations = profiler_annotations
        if jsonl_path:
            # line-buffered append: whole-line writes interleave safely
            # when several tracers in one process share a path
            self._sink = open(jsonl_path, "a", buffering=1)

    # -- raw event sink -------------------------------------------------
    def event(self, type: str, **fields) -> None:
        """Write an arbitrary event to the JSONL log (no-op without one)."""
        if self._sink is None:
            return
        rec = {"type": type, "t": time.perf_counter(), **fields}
        with self._lock:
            self._sink.write(json.dumps(rec, default=str) + "\n")

    # -- spans ----------------------------------------------------------
    def start(self, name: str, rid: Optional[object] = None,
              t: Optional[float] = None, **attrs) -> str:
        t0 = time.perf_counter() if t is None else t
        span_id = f"{self._prefix}-{next(self._seq)}"
        sp = Span(span_id, name, rid, t0, None, dict(attrs))
        with self._lock:
            self._open[span_id] = sp
            if self._sink is not None:
                self._sink.write(json.dumps(
                    {"type": "span_start", "span": span_id, "name": name,
                     "rid": rid, "t": t0, **attrs}, default=str) + "\n")
        return span_id

    def end(self, span_id: str, t: Optional[float] = None, **attrs) -> Span:
        t1 = time.perf_counter() if t is None else t
        with self._lock:
            sp = self._open.pop(span_id, None)
            if sp is None:
                raise KeyError(f"end() on unknown/already-ended span {span_id!r}")
            if t1 < sp.t0:
                # put it back so the failure is observable, then refuse
                self._open[span_id] = sp
                raise ValueError(
                    f"span {sp.name!r} ({span_id}): negative duration "
                    f"({t1 - sp.t0:.9f}s) — timestamps must come from "
                    f"time.perf_counter()")
            sp.t1 = t1
            sp.attrs.update(attrs)
            self.spans.append(sp)
            if self._sink is not None:
                self._sink.write(json.dumps(
                    {"type": "span_end", "span": span_id, "name": sp.name,
                     "rid": sp.rid, "t": t1, "dur_s": t1 - sp.t0,
                     **sp.attrs}, default=str) + "\n")
        return sp

    @contextlib.contextmanager
    def span(self, name: str, rid: Optional[object] = None, **attrs):
        """Same-thread scope. With ``profiler_annotations=True`` the
        scope is also a ``torch.profiler.record_function(name)``, so the
        host span lines up with the card's kernels in a profiler trace
        (it records nothing while no profiler runs)."""
        ann = contextlib.nullcontext()
        if self.profiler_annotations:
            from torch.profiler import record_function
            ann = record_function(name)
        with ann:
            span_id = self.start(name, rid, **attrs)
            try:
                yield span_id
            finally:
                self.end(span_id)

    # -- aggregation ----------------------------------------------------
    def open_count(self) -> int:
        return len(self._open)

    def span_stats(self) -> Dict[str, dict]:
        """Per-span-name {count, p50_ms, p99_ms, mean_ms, total_s} over
        the ring buffer (exact percentiles over retained spans)."""
        by_name: Dict[str, List[float]] = {}
        with self._lock:
            finished = list(self.spans)
        for sp in finished:
            by_name.setdefault(sp.name, []).append(sp.duration_s)
        out = {}
        for name, durs in sorted(by_name.items()):
            durs.sort()
            out[name] = {
                "count": len(durs),
                "p50_ms": round(_percentile(durs, 0.50) * 1e3, 3),
                "p99_ms": round(_percentile(durs, 0.99) * 1e3, 3),
                "mean_ms": round((sum(durs) / len(durs)) * 1e3, 3),
                "total_s": round(sum(durs), 6),
            }
        return out

    def snapshot(self, last: int = 256) -> List[dict]:
        with self._lock:
            finished = list(self.spans)[-last:]
        return [sp.to_dict() for sp in finished]

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()
                self._sink.close()
                self._sink = None


class NullTracer(Tracer):
    """No-op tracer with the same surface (the uninstrumented mode)."""

    enabled = False

    def __init__(self) -> None:
        super().__init__(capacity=1)

    def event(self, type: str, **fields) -> None:
        pass

    def start(self, name, rid=None, t=None, **attrs) -> str:
        return ""

    def end(self, span_id, t=None, **attrs) -> Span:
        return Span("", "", None, 0.0, 0.0)

    @contextlib.contextmanager
    def span(self, name, rid=None, **attrs):
        yield ""

    def span_stats(self) -> Dict[str, dict]:
        return {}

    def snapshot(self, last: int = 256) -> List[dict]:
        return []
