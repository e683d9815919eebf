"""Validator for observability artifacts (port of repro/obs/validate.py).

Usage::

    python -m repro_torch.obs.validate --jsonl obs.jsonl \
        --prom metrics.prom \
        --require msda_compiles_total serve_requests_total \
                  serve_request_latency_seconds

Asserts:
- the Prometheus text parses (strict parser, any malformed line fails);
- every ``--require`` metric name is present in the Prometheus text
  (histograms may appear via their ``_count`` series) and in the
  ``metrics`` events of the JSONL log;
- every span in the JSONL log is well-formed: ``span_end`` pairs with a
  prior ``span_start`` of the same id/name, durations are non-negative,
  and no span is left open.

Exit code 0 on success, 1 with a reason on stderr otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.obs.export import parse_prometheus_text


def validate_jsonl(path: str) -> dict:
    """Returns {"events", "spans", "names", "metrics"}: counts, span names
    and the metric names its ``metrics`` events carry; raises ValueError
    on any structural problem."""
    open_spans: Dict[str, dict] = {}
    n_events = n_spans = 0
    names = set()
    metrics = set()
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                ev = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON ({e})")
            if not isinstance(ev, dict) or "type" not in ev:
                raise ValueError(f"{path}:{lineno}: event without type")
            n_events += 1
            etype = ev["type"]
            if etype == "span_start":
                sid = ev.get("span")
                if not sid:
                    raise ValueError(f"{path}:{lineno}: span_start without id")
                if sid in open_spans:
                    raise ValueError(f"{path}:{lineno}: duplicate span_start "
                                     f"for {sid!r}")
                open_spans[sid] = ev
            elif etype == "span_end":
                sid = ev.get("span")
                start = open_spans.pop(sid, None)
                if start is None:
                    raise ValueError(f"{path}:{lineno}: span_end for "
                                     f"{sid!r} without matching span_start")
                if ev.get("name") != start.get("name"):
                    raise ValueError(
                        f"{path}:{lineno}: span {sid!r} name mismatch "
                        f"({start.get('name')!r} -> {ev.get('name')!r})")
                dur = ev.get("dur_s")
                if dur is None or dur < 0:
                    raise ValueError(f"{path}:{lineno}: span {sid!r} has "
                                     f"negative/missing duration {dur!r}")
                if ev.get("t", 0.0) < start.get("t", 0.0):
                    raise ValueError(f"{path}:{lineno}: span {sid!r} ends "
                                     f"before it starts")
                n_spans += 1
                names.add(ev.get("name"))
            elif etype == "metrics":
                data = ev.get("data") or {}
                metrics.update(name for section in data.values()
                               if isinstance(section, dict)
                               for name in section)
    if open_spans:
        sids = sorted(open_spans)[:5]
        raise ValueError(f"{path}: {len(open_spans)} span(s) never ended "
                         f"(e.g. {sids})")
    return {"events": n_events, "spans": n_spans,
            "names": sorted(n for n in names if n),
            "metrics": sorted(metrics)}


def validate_prometheus(path: str, require: List[str]) -> dict:
    with open(path) as f:
        parsed = parse_prometheus_text(f.read())
    present = set(parsed)
    missing = [name for name in require
               if name not in present and f"{name}_count" not in present]
    if missing:
        raise ValueError(f"{path}: required metrics missing: {missing} "
                         f"(present: {sorted(present)})")
    return {"series": len(parsed), "names": sorted(present)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--jsonl", default=None, help="span event log to check")
    ap.add_argument("--prom", default=None, help="Prometheus text to check")
    ap.add_argument("--require", nargs="*", default=[],
                    help="metric names that must be present in --prom and "
                         "in the metrics events of --jsonl")
    ap.add_argument("--min-spans", type=int, default=1,
                    help="minimum finished spans expected in --jsonl")
    args = ap.parse_args(argv)
    if not args.jsonl and not args.prom:
        ap.error("nothing to validate: pass --jsonl and/or --prom")
    try:
        if args.jsonl:
            r = validate_jsonl(args.jsonl)
            if r["spans"] < args.min_spans:
                raise ValueError(f"{args.jsonl}: only {r['spans']} finished "
                                 f"span(s), expected >= {args.min_spans}")
            missing = [n for n in args.require if n not in r["metrics"]]
            if missing:
                raise ValueError(f"{args.jsonl}: required metrics missing from "
                                 f"its metrics events: {missing} "
                                 f"(present: {r['metrics']})")
            print(f"[obs-validate] {args.jsonl}: {r['events']} events, "
                  f"{r['spans']} well-formed spans "
                  f"({', '.join(r['names'])})")
        if args.prom:
            r = validate_prometheus(args.prom, args.require)
            print(f"[obs-validate] {args.prom}: {r['series']} series parse; "
                  f"required metrics present")
    except (ValueError, OSError) as e:
        print(f"[obs-validate] FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
