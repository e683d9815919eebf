"""Exporters: Prometheus exposition text + JSON snapshots (port of
repro/obs/export.py; the snapshot schema stays ``repro.obs/v1``).

``prometheus_text`` renders a ``MetricsRegistry`` snapshot into the
text exposition format (HELP/TYPE headers, cumulative ``_bucket``
series with ``le`` labels, ``_sum``/``_count``).  ``parse_prometheus_text``
is the strict inverse used by the validator — it raises ``ValueError``
on any malformed line, so "the Prometheus text parses" is a real gate.

``json_snapshot`` bundles metrics + span stats (+ optional extras such
as plan snapshots) into one machine-readable dict that
``make_experiments_md`` and the dashboard consume.
"""
from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^ ]+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def prometheus_text(registry: MetricsRegistry) -> str:
    snap = registry.snapshot()
    lines: List[str] = []
    for section, kind in (("counters", "counter"), ("gauges", "gauge"),
                          ("histograms", "histogram")):
        for name, entry in snap[section].items():
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {kind}")
            if kind != "histogram":
                for v in entry["values"]:
                    lines.append(f"{name}{_fmt_labels(v['labels'])} "
                                 f"{_fmt_value(v['value'])}")
                continue
            for v in entry["values"]:
                cum = 0
                for le, c in v["buckets"]:
                    cum = c
                    lab = dict(v["labels"], le=_fmt_value(le))
                    lines.append(f"{name}_bucket{_fmt_labels(lab)} {c}")
                lab = dict(v["labels"], le="+Inf")
                lines.append(f"{name}_bucket{_fmt_labels(lab)} {v['count']}")
                lines.append(f"{name}_sum{_fmt_labels(v['labels'])} "
                             f"{_fmt_value(v['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(v['labels'])} "
                             f"{v['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """Strict parser for the exposition format we emit.

    Returns {metric_name: [(labels, value), ...]}; histogram series come
    back under their ``_bucket``/``_sum``/``_count`` names.  Raises
    ``ValueError`` on any line that is neither a comment nor a valid
    sample."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 2)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: malformed comment {raw!r}")
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {raw!r}")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body:
            consumed = 0
            for lm in _LABEL_RE.finditer(body):
                labels[lm.group(1)] = lm.group(2)
                consumed = lm.end()
            rest = body[consumed:].strip().strip(",")
            if rest:
                raise ValueError(f"line {lineno}: malformed labels {body!r}")
        val_s = m.group("value")
        try:
            value = float("inf") if val_s == "+Inf" else float(val_s)
        except ValueError:
            raise ValueError(f"line {lineno}: malformed value {val_s!r}")
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def json_snapshot(registry: MetricsRegistry,
                  tracer: Optional[Tracer] = None,
                  extra: Optional[dict] = None) -> dict:
    snap = {
        "schema": "repro.obs/v1",
        "wall_time": time.time(),
        "metrics": registry.snapshot(),
        "spans": tracer.span_stats() if tracer is not None else {},
    }
    if extra:
        snap.update(extra)
    return snap


def write_json_snapshot(path: str, registry: MetricsRegistry,
                        tracer: Optional[Tracer] = None,
                        extra: Optional[dict] = None) -> dict:
    snap = json_snapshot(registry, tracer, extra)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, default=str)
        f.write("\n")
    return snap
