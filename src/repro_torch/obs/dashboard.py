"""Terminal dashboard: tail a live engine's JSONL event log and render
queue depth, rps, per-span latency, staged-bytes and plan provenance
(port of repro/obs/dashboard.py).

Run against a live engine (point ``REPRO_OBS_JSONL`` at a file, start
the engine, then)::

    python -m repro_torch.obs.dashboard --jsonl /tmp/obs.jsonl --follow

or render a finished log once (``--once`` is the default).  Pure
functions (``build_model`` / ``render_dashboard``) are kept separate
from the tailing loop so tests can feed synthetic events.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Dict, List, Optional

_SPAN_KEEP = 2048  # per-name durations retained for percentile estimates


def new_model() -> dict:
    return {
        "spans": collections.defaultdict(
            lambda: collections.deque(maxlen=_SPAN_KEEP)),
        "metrics": None,          # latest metrics snapshot event
        "metrics_prev": None,     # the one before (for rates)
        "plans": [],              # plan events in arrival order
        "t_first": None,
        "t_last": None,
        "events": 0,
    }


def feed_event(model: dict, ev: dict) -> None:
    t = ev.get("t")
    if isinstance(t, (int, float)):
        if model["t_first"] is None:
            model["t_first"] = t
        model["t_last"] = t
    model["events"] += 1
    etype = ev.get("type")
    if etype == "span_end":
        dur = ev.get("dur_s")
        name = ev.get("name")
        if name and isinstance(dur, (int, float)):
            model["spans"][name].append(float(dur))
    elif etype == "metrics":
        model["metrics_prev"] = model["metrics"]
        model["metrics"] = ev
    elif etype == "plan":
        model["plans"].append(ev)


def feed_lines(model: dict, lines) -> None:
    for raw in lines:
        raw = raw.strip()
        if not raw:
            continue
        try:
            feed_event(model, json.loads(raw))
        except json.JSONDecodeError:
            continue  # torn tail line mid-write; next poll completes it


def _pct(durs: List[float], q: float) -> float:
    if not durs:
        return float("nan")
    s = sorted(durs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _counter_values(snap: Optional[dict], name: str) -> List[dict]:
    if not snap:
        return []
    return (snap.get("data", {}).get("counters", {})
            .get(name, {}).get("values", []))


def _gauge_values(snap: Optional[dict], name: str) -> List[dict]:
    if not snap:
        return []
    return (snap.get("data", {}).get("gauges", {})
            .get(name, {}).get("values", []))


def _counter_total(snap: Optional[dict], name: str,
                   **match: str) -> float:
    tot = 0.0
    for v in _counter_values(snap, name):
        if all(v["labels"].get(k) == str(val) for k, val in match.items()):
            tot += v["value"]
    return tot


def render_dashboard(model: dict, width: int = 72) -> str:
    bar = "─" * (width - 2)
    out = [f"┌{bar}┐"]

    def row(text: str = "") -> None:
        out.append("│ " + text[:width - 4].ljust(width - 4) + " │")

    def section(title: str) -> None:
        out.append(f"├{bar}┤")
        row(title)

    snap = model["metrics"]
    elapsed = ((model["t_last"] - model["t_first"])
               if model["t_first"] is not None else 0.0)
    completed = _counter_total(snap, "serve_requests_total",
                               outcome="completed")
    # rate over the last metrics interval when it saw completions (live
    # view), else the whole-log average (finished logs end with flush
    # events whose interval completed nothing)
    prev = model["metrics_prev"]
    rps = completed / elapsed if elapsed > 0 else 0.0
    if prev is not None and snap is not None:
        dt = snap.get("t", 0.0) - prev.get("t", 0.0)
        dc = completed - _counter_total(prev, "serve_requests_total",
                                        outcome="completed")
        if dt > 0 and dc > 0:
            rps = dc / dt

    row(f"repro_torch.obs dashboard — {model['events']} events, "
        f"{elapsed:.1f}s window")
    row(f"requests completed: {completed:.0f}   rps: {rps:.1f}")

    depths = _gauge_values(snap, "serve_queue_depth")
    if depths:
        section("queue depth (per bucket)")
        for v in depths:
            b = v["labels"].get("bucket", "?")
            n = int(v["value"])
            row(f"  bucket {b:>5}: {'█' * min(n, 40)}{n:>4}")

    if model["spans"]:
        section("latency by span (ms)        count      p50      p99")
        for name in sorted(model["spans"]):
            durs = list(model["spans"][name])
            row(f"  {name:<24} {len(durs):>8} {_pct(durs, .5)*1e3:>8.2f} "
                f"{_pct(durs, .99)*1e3:>8.2f}")

    staged = _counter_values(snap, "staged_bytes_total")
    frames_tot = _counter_total(snap, "stream_frames_total")
    if staged:
        section("staged bytes")
        for v in staged:
            mode = v["labels"].get("mode", "?")
            kb = v["value"] / 1024.0
            per = (f"  ({v['value']/frames_tot/1024.0:.1f} KB/frame)"
                   if mode == "incremental" and frames_tot else "")
            row(f"  mode={mode:<12} {kb:>10.1f} KB{per}")
        inc = _counter_total(snap, "stream_frames_total", mode="incremental")
        reb = _counter_total(snap, "stream_frames_total", mode="rebuild")
        if inc or reb:
            row(f"  incremental:rebuild frames = {inc:.0f}:{reb:.0f}")
        for v in _counter_values(snap, "stream_rebuilds_total"):
            row(f"  rebuild reason {v['labels'].get('reason', '?'):<16} "
                f"x{v['value']:.0f}")

    if model["plans"]:
        section("plans (budget provenance)")
        for ev in model["plans"][-6:]:
            p = ev.get("plan", {})
            where = ev.get("bucket", ev.get("engine", "?"))
            row(f"  [{where}] backend={p.get('backend', '?')} "
                f"budget={p.get('budget_source', '?')} "
                f"tdtype={p.get('table_dtype', '?')} "
                f"table={p.get('value_table_bytes', 0)/1024.0:.0f}KB")

    out.append(f"└{bar}┘")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--jsonl", required=True, help="event log to tail")
    ap.add_argument("--follow", action="store_true",
                    help="keep tailing and re-rendering (default: once)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--width", type=int, default=72)
    args = ap.parse_args(argv)

    model = new_model()
    with open(args.jsonl) as f:
        feed_lines(model, f)
        if not args.follow:
            print(render_dashboard(model, width=args.width))
            return 0
        while True:
            sys.stdout.write("\x1b[2J\x1b[H")
            print(render_dashboard(model, width=args.width))
            time.sleep(args.interval)
            feed_lines(model, f)


if __name__ == "__main__":
    sys.exit(main())
