"""Process-local metrics registry: counters, gauges, fixed-bucket
histograms (port of repro/obs/metrics.py; names, label sets and the
snapshot layout are the reference's).

- **Host-side only.** Values are plain Python floats. Engines touch the
  registry outside any captured CUDA graph, except the bumps that run
  once while a graph is prepared (the compile-count spy), which never
  move again under replay.
- **Lock-free hot path.** ``inc`` / ``set`` / ``observe`` are plain
  dict/list mutations, atomic enough under the GIL for the
  single-writer-per-label-set pattern the engines follow. Only metric
  *creation* takes a lock.
- **Fixed buckets.** Histograms pre-declare their upper bounds.

Label sets are keyword arguments, stored keyed by the sorted
``(key, value)`` tuple, Prometheus-style::

    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(bucket="64", outcome="completed")
    reg.value("serve_requests_total", bucket="64", outcome="completed")  # 1.0
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Default latency buckets (seconds): sub-ms through 10 s, roughly
# logarithmic — wide enough for CPU runs and the card.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Byte-count buckets: 1 KiB .. 1 GiB.
DEFAULT_BYTES_BUCKETS = tuple(float(1 << s) for s in range(10, 31, 2))


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum across all label sets."""
        return float(sum(self._values.values()))

    def collect(self) -> List[dict]:
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())]


class Gauge:
    """Last-write-wins value, optionally labelled."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> List[dict]:
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())]


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int) -> None:
        # counts[i] observations <= bounds[i]; counts[-1] is +Inf overflow
        self.counts = [0] * (n_buckets + 1)
        self.sum = 0.0
        self.count = 0


class Histogram:
    """Fixed-bucket histogram (cumulative on export, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS) -> None:
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted "
                             f"and non-empty, got {buckets!r}")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series.setdefault(key, _HistSeries(len(self.buckets)))
        s.counts[bisect.bisect_left(self.buckets, value)] += 1
        s.sum += value
        s.count += 1

    def count(self, **labels: str) -> int:
        s = self._series.get(_label_key(labels))
        return s.count if s else 0

    def total_count(self) -> int:
        return sum(s.count for s in self._series.values())

    def sum_value(self, **labels: str) -> float:
        s = self._series.get(_label_key(labels))
        return s.sum if s else 0.0

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation); None when empty."""
        s = self._series.get(_label_key(labels))
        if not s or not s.count:
            return None
        rank = q * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            cum += c
            if cum >= rank:
                return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")

    def collect(self) -> List[dict]:
        out = []
        for key, s in sorted(self._series.items()):
            cum, cum_counts = 0, []
            for c in s.counts[:-1]:
                cum += c
                cum_counts.append(cum)
            out.append({"labels": dict(key), "count": s.count, "sum": s.sum,
                        "buckets": [[b, c] for b, c
                                    in zip(self.buckets, cum_counts)]})
        return out


class MetricsRegistry:
    """Named metric family store.  ``counter``/``gauge``/``histogram``
    get-or-create; ``snapshot`` renders everything to plain dicts."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered "
                                f"as {type(m).__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def value(self, name: str, **labels: str) -> float:
        """Convenience: current value of a counter/gauge label set
        (0.0 when the metric or label set does not exist)."""
        m = self._metrics.get(name)
        if m is None or isinstance(m, Histogram):
            return 0.0
        return m.value(**labels)

    def snapshot(self) -> dict:
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in self.names():
            m = self._metrics[name]
            sec = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}[m.kind]
            entry = {"help": m.help, "values": m.collect()}
            if m.kind == "histogram":
                entry["bucket_bounds"] = list(m.buckets)
            out[sec][name] = entry
        return out


class _NullMetric:
    """Accepts every Counter/Gauge/Histogram call and does nothing."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.help = ""
        self.buckets = ()

    def inc(self, *a, **k): pass
    def dec(self, *a, **k): pass
    def set(self, *a, **k): pass
    def observe(self, *a, **k): pass
    def value(self, **labels): return 0.0
    def total(self): return 0.0
    def count(self, **labels): return 0
    def total_count(self): return 0
    def sum_value(self, **labels): return 0.0
    def quantile(self, q, **labels): return None
    def collect(self): return []


class NullRegistry(MetricsRegistry):
    """Same API as MetricsRegistry, zero work: the uninstrumented mode.

    Returned metrics swallow every update, so engine code carries no
    ``if obs.enabled`` branches on the hot path."""

    enabled = False

    def __init__(self) -> None:
        super().__init__()
        self._null = _NullMetric()

    def counter(self, name: str, help: str = "") -> Counter:  # type: ignore[override]
        return self._null  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:  # type: ignore[override]
        return self._null  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "", buckets=()):  # type: ignore[override]
        return self._null

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide shared registry.

    Engines default to their *own* registries (exact per-engine
    assertions); the shared one collects process-global
    events — e.g. ``msda_cache_build_traces_total``, bumped by every
    ``build_value_cache`` call outside a CUDA-graph replay, where no
    per-engine handle can reach."""
    global _default_registry
    if _default_registry is None:
        with _default_lock:
            if _default_registry is None:
                _default_registry = MetricsRegistry()
    return _default_registry
