"""The port's telemetry package ``repro_torch.obs`` against the
reference's ``repro.obs``.

The registry, tracer, exporter, validator and dashboard tests of
``tests/test_obs.py`` run against the port (exact: the package is
host-side Python in both), and parity tests import both packages: one
sequence of metric operations renders the same Prometheus text and the
same snapshot keys in both, a JSONL log written by either tracer passes
both validators, and the port's ``MSDAPlan.snapshot()`` keeps the
reference's keys and values for the fields the two plans share."""
import json
import threading

import pytest

torch = pytest.importorskip("torch")

from repro import obs as robs  # noqa: E402
from repro.obs import validate as rvalidate  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import (MetricsRegistry, Observability, Tracer,  # noqa: E402
                             json_snapshot, parse_prometheus_text,
                             prometheus_text)
from repro_torch.obs import validate as tvalidate  # noqa: E402
from repro_torch.obs.metrics import DEFAULT_BYTES_BUCKETS, default_registry  # noqa: E402

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

def test_counter_labels_total_and_negative_guard():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "test counter")
    c.inc(bucket="32")
    c.inc(2.0, bucket="64", outcome="completed")
    assert c.value(bucket="32") == 1.0
    assert c.value(outcome="completed", bucket="64") == 2.0   # label order
    assert c.value(bucket="none") == 0.0
    assert c.total() == 3.0
    with pytest.raises(ValueError):
        c.inc(-1.0)
    assert reg.counter("requests_total") is c
    with pytest.raises(TypeError):
        reg.gauge("requests_total")


def test_gauge_set_inc_dec():
    g = MetricsRegistry().gauge("queue_depth")
    g.set(5, bucket="32")
    g.inc(bucket="32")
    g.dec(2, bucket="32")
    assert g.value(bucket="32") == 4.0


def test_histogram_buckets_quantile_and_counts():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.005, 0.05, 0.5, 5.0):
        h.observe(v, span="device")
    assert h.count(span="device") == 5 and h.total_count() == 5
    assert h.sum_value(span="device") == pytest.approx(5.56)
    assert h.quantile(0.5, span="device") == 0.1
    assert h.quantile(0.99, span="device") == float("inf")
    assert h.quantile(0.5, span="nope") is None
    (series,) = h.collect()
    assert series["buckets"] == [[0.01, 2], [0.1, 3], [1.0, 4]]  # cumulative
    assert series["count"] == 5
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(1.0, 0.1))


def test_registry_snapshot_shape():
    reg = MetricsRegistry()
    reg.counter("c_total").inc(k="v")
    reg.gauge("g").set(2.0)
    reg.histogram("h_seconds", buckets=DEFAULT_BYTES_BUCKETS).observe(2048.0)
    snap = reg.snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert snap["counters"]["c_total"]["values"] == [
        {"labels": {"k": "v"}, "value": 1.0}]
    assert snap["histograms"]["h_seconds"]["bucket_bounds"] == \
        list(DEFAULT_BYTES_BUCKETS)
    json.dumps(snap)


def test_null_registry_and_tracer_are_inert():
    obs = Observability.disabled()
    assert not obs.enabled
    obs.metrics.counter("x_total").inc(a="b")
    obs.metrics.gauge("g").set(1.0)
    obs.metrics.histogram("h").observe(1.0)
    assert obs.metrics.snapshot() == {"counters": {}, "gauges": {},
                                      "histograms": {}}
    obs.tracer.end(obs.tracer.start("queue"))
    with obs.tracer.span("device"):
        pass
    assert obs.tracer.span_stats() == {} and obs.tracer.snapshot() == []


def test_default_registry_is_a_process_singleton():
    assert default_registry() is default_registry()
    assert isinstance(default_registry(), MetricsRegistry)
    assert default_registry() is not robs.default_registry()


# --------------------------------------------------------------------------
# prometheus export
# --------------------------------------------------------------------------

def test_prometheus_text_round_trips_through_strict_parser():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests").inc(3, bucket="32")
    reg.counter("req_total").inc(bucket="64", outcome="ok")
    reg.gauge("depth", "queue depth").set(7, bucket="32")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    parsed = parse_prometheus_text(prometheus_text(reg))
    assert (frozenset({"bucket": "32"}.items()), 3.0) in [
        (frozenset(lab.items()), v) for lab, v in parsed["req_total"]]
    assert parsed["depth"] == [({"bucket": "32"}, 7.0)]
    le = {lab["le"] if lab["le"] == "+Inf" else float(lab["le"]): v
          for lab, v in parsed["lat_seconds_bucket"]}
    assert le == {0.1: 1.0, 1.0: 2.0, "+Inf": 2.0}
    assert parsed["lat_seconds_count"] == [({}, 2.0)]
    assert parsed["lat_seconds_sum"][0][1] == pytest.approx(0.55)


@pytest.mark.parametrize("bad", [
    "not a metric line at all {",
    'x_total{unterminated="1 3.0',
    "x_total not-a-number",
    "# MALFORMED comment kind",
])
def test_prometheus_parser_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_prometheus_text(bad + "\n")


# --------------------------------------------------------------------------
# tracer
# --------------------------------------------------------------------------

def test_tracer_spans_ring_buffer_and_stats():
    tr = Tracer(capacity=4)
    for i in range(6):
        tr.end(tr.start("step", rid=i), items=i)
    assert [s.rid for s in tr.spans] == [2, 3, 4, 5]     # bounded ring
    st = tr.span_stats()["step"]
    assert st["count"] == 4 and st["p50_ms"] >= 0.0
    assert tr.open_count() == 0
    snap = tr.snapshot(last=2)
    assert len(snap) == 2 and snap[-1]["rid"] == 5


def test_tracer_unknown_end_and_negative_duration_raise():
    tr = Tracer()
    with pytest.raises(KeyError):
        tr.end("t0-999")
    sid = tr.start("queue", t=100.0)
    with pytest.raises(ValueError, match="negative duration"):
        tr.end(sid, t=99.0)
    assert tr.open_count() == 1
    assert tr.end(sid, t=101.5).duration_s == pytest.approx(1.5)


def test_tracer_cross_thread_end():
    tr = Tracer()
    sid = tr.start("device", rid=7)
    t = threading.Thread(target=lambda: tr.end(sid))
    t.start()
    t.join()
    assert tr.open_count() == 0 and tr.spans[-1].rid == 7


def test_span_bridge_shows_in_a_torch_profile():
    """The port's span bridge: with ``profiler_annotations`` a span is a
    ``torch.profiler.record_function`` range of the same name."""
    tr = Tracer(profiler_annotations=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("postproc_probe"):
            torch.ones(4).sum()
    assert "postproc_probe" in [e.key for e in prof.key_averages()]
    assert tr.span_stats()["postproc_probe"]["count"] == 1


def test_tracer_jsonl_sink_and_validator(tmp_path):
    path = str(tmp_path / "events.jsonl")
    obs = Observability.create(jsonl_path=path)
    with obs.tracer.span("frame_in", rid="s0", n=2):
        pass
    obs.metrics.counter("frames_total").inc()
    obs.flush_metrics()
    obs.tracer.event("plan", engine="test", plan={"backend": "torch_gather"})
    obs.close()
    r = tvalidate.validate_jsonl(path)
    assert r["spans"] == 1 and r["names"] == ["frame_in"]
    assert r["metrics"] == ["frames_total"]
    types = [json.loads(line)["type"] for line in open(path)]
    assert types == ["span_start", "span_end", "metrics", "plan"]
    assert tvalidate.main(["--jsonl", path, "--require", "frames_total"]) == 0
    assert tvalidate.main(["--jsonl", path, "--require", "serve_x_total"]) == 1


def test_validator_rejects_broken_logs(tmp_path):
    def _check(lines, match):
        p = tmp_path / "bad.jsonl"
        p.write_text("\n".join(json.dumps(e) for e in lines) + "\n")
        with pytest.raises(ValueError, match=match):
            tvalidate.validate_jsonl(str(p))
        assert tvalidate.main(["--jsonl", str(p)]) == 1

    start = {"type": "span_start", "span": "a", "name": "q", "t": 1.0}
    _check([start], "never ended")
    _check([{"type": "span_end", "span": "a", "name": "q", "t": 2.0,
             "dur_s": 1.0}], "without matching")
    _check([start, {"type": "span_end", "span": "a", "name": "q", "t": 2.0,
                    "dur_s": -0.5}], "negative/missing duration")
    _check([start, {"type": "span_end", "span": "a", "name": "other",
                    "t": 2.0, "dur_s": 1.0}], "name mismatch")
    _check([start, start], "duplicate span_start")


def test_validator_checks_prometheus_text(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(bucket="32", outcome="admitted")
    reg.histogram("serve_request_latency_seconds").observe(0.01)
    p = tmp_path / "metrics.prom"
    p.write_text(prometheus_text(reg))
    assert tvalidate.main(["--prom", str(p), "--require", "serve_requests_total",
                           "serve_request_latency_seconds"]) == 0
    assert tvalidate.main(["--prom", str(p), "--require",
                           "msda_compiles_total"]) == 1


# --------------------------------------------------------------------------
# json snapshot + dashboard
# --------------------------------------------------------------------------

def test_json_snapshot_schema(tmp_path):
    from repro_torch.obs import write_json_snapshot
    obs = Observability.create()
    obs.metrics.counter("c_total").inc()
    with obs.tracer.span("device"):
        pass
    snap = json_snapshot(obs.metrics, obs.tracer, extra={"run": "t1"})
    assert snap["schema"] == "repro.obs/v1"
    assert snap["metrics"]["counters"]["c_total"]["values"][0]["value"] == 1.0
    assert snap["spans"]["device"]["count"] == 1 and snap["run"] == "t1"
    p = tmp_path / "snap.json"
    write_json_snapshot(str(p), obs.metrics, obs.tracer)
    assert json.loads(p.read_text())["schema"] == "repro.obs/v1"
    obs.close()


def _synthetic_events():
    snap = {"counters": {
        "serve_requests_total": {"help": "", "values": [
            {"labels": {"bucket": "32", "outcome": "completed"},
             "value": 9.0}]},
        "staged_bytes_total": {"help": "", "values": [
            {"labels": {"mode": "incremental"}, "value": 4096.0},
            {"labels": {"mode": "rebuild"}, "value": 65536.0}]},
        "stream_frames_total": {"help": "", "values": [
            {"labels": {"mode": "incremental"}, "value": 8.0},
            {"labels": {"mode": "rebuild"}, "value": 1.0}]},
        "stream_rebuilds_total": {"help": "", "values": [
            {"labels": {"reason": "cold"}, "value": 1.0}]},
    }, "gauges": {
        "serve_queue_depth": {"help": "", "values": [
            {"labels": {"bucket": "32"}, "value": 3.0}]},
    }, "histograms": {}}
    return [
        {"type": "span_start", "span": "a", "name": "device", "t": 1.0},
        {"type": "span_end", "span": "a", "name": "device", "t": 1.02,
         "dur_s": 0.02},
        {"type": "plan", "t": 1.1, "bucket": "32",
         "plan": {"backend": "torch_gather", "budget_source": "measured",
                  "table_dtype": "float32", "value_table_bytes": 43520}},
        {"type": "metrics", "t": 2.0, "data": snap},
    ]


def test_dashboard_renders_synthetic_events():
    from repro_torch.obs.dashboard import feed_event, new_model, render_dashboard
    model = new_model()
    for ev in _synthetic_events():
        feed_event(model, ev)
    out = render_dashboard(model, width=80)
    assert "requests completed: 9" in out
    assert "bucket    32: ███" in out
    assert "device" in out and "20.00" in out
    assert "incremental:rebuild frames = 8:1" in out
    assert "rebuild reason cold" in out
    assert "backend=torch_gather" in out and "budget=measured" in out
    assert all(len(line) == 80 for line in out.splitlines())


def test_dashboard_feed_lines_tolerates_torn_tail():
    from repro_torch.obs.dashboard import feed_lines, new_model
    model = new_model()
    lines = [json.dumps(e) for e in _synthetic_events()]
    lines.append('{"type": "span_start", "span": "b", "na')   # torn write
    feed_lines(model, lines)
    assert model["events"] == 4


def test_dashboard_cli_renders_a_log_once(tmp_path, capsys):
    from repro_torch.obs.dashboard import main
    p = tmp_path / "events.jsonl"
    p.write_text("\n".join(json.dumps(e) for e in _synthetic_events()) + "\n")
    assert main(["--jsonl", str(p)]) == 0
    assert "repro_torch.obs dashboard — 4 events" in capsys.readouterr().out


# --------------------------------------------------------------------------
# parity with the reference package
# --------------------------------------------------------------------------

def _drive(pkg):
    """One sequence of counter, gauge and histogram operations."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("serve_requests_total", "requests by bucket and outcome")
    c.inc(bucket="512", outcome="admitted")
    c.inc(3, bucket="1024", outcome="completed")
    c.inc(bucket="none", outcome="rejected")
    g = reg.gauge("serve_queue_depth", "admitted requests waiting per bucket")
    g.set(4, bucket="512")
    g.dec(1.5, bucket="512")
    g.inc(bucket="1024")
    h = reg.histogram("serve_span_seconds", "per-stage latency (label span=)")
    for v in (0.0004, 0.003, 0.003, 0.2, 12.0):
        h.observe(v, span="device")
    h.observe(0.07, span="queue")
    reg.histogram("staged_bytes", buckets=pkg.metrics.DEFAULT_BYTES_BUCKETS
                  ).observe(3e6)
    return reg


def test_same_operations_give_identical_prometheus_text_and_snapshot_keys():
    ref, port = _drive(robs), _drive(tobs)
    assert tobs.prometheus_text(port) == robs.prometheus_text(ref)
    assert port.snapshot() == ref.snapshot()
    rs = robs.json_snapshot(ref, robs.Tracer())
    ts = tobs.json_snapshot(port, tobs.Tracer())
    assert set(ts) == set(rs) and ts["schema"] == rs["schema"]
    assert ts["metrics"] == rs["metrics"]
    # each package's parser reads the other's text
    assert tobs.parse_prometheus_text(robs.prometheus_text(ref)) == \
        robs.parse_prometheus_text(tobs.prometheus_text(port))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_jsonl_log_of_either_tracer_passes_both_validators(writer, tmp_path):
    pkg = robs if writer == "reference" else tobs
    path = str(tmp_path / f"{writer}.jsonl")
    obs = pkg.Observability.create(jsonl_path=path)
    sid = obs.tracer.start("queue", rid=1, bucket=32)
    with obs.tracer.span("callback", rid=1):
        pass
    obs.tracer.end(sid)
    obs.tracer.event("plan", engine="DetrServeEngine", bucket=32,
                     plan={"backend": "x"})
    obs.metrics.counter("msda_compiles_total").inc(bucket="32")
    obs.metrics.counter("serve_requests_total").inc(bucket="32",
                                                    outcome="completed")
    obs.flush_metrics()
    obs.close()
    want = rvalidate.validate_jsonl(path)
    got = tvalidate.validate_jsonl(path)
    assert {k: got[k] for k in want} == want
    assert want["names"] == ["callback", "queue"]
    for v in (rvalidate, tvalidate):
        assert v.main(["--jsonl", path, "--require", "msda_compiles_total",
                       "serve_requests_total"]) == 0


def _plan_pair(backends, n_queries=None, n_consumers=1, table_dtype=None):
    from repro import msda as rmsda
    from repro.core.msdeform_attn import MSDeformAttnConfig as RCfg
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig as TCfg
    from repro_torch.msda.plan import make_plan
    kw = dict(d_model=32, n_heads=4, fwp_mode="compact", fwp_k=1.0,
              fwp_capacity=0.6, range_narrow=(4.0, 3.0, 2.0),
              table_dtype=table_dtype)
    shapes = ((8, 10), (4, 5), (2, 3))
    # both planners held to the same budgets (their static defaults are a
    # TPU's VMEM and an H100's L2)
    budgets = dict(vmem_budget_bytes=2**20, staging_budget_bytes=2**19,
                   budget_source="static")
    ref = rmsda.make_plan(RCfg(**kw), shapes, backend=backends[0],
                          n_queries=n_queries, n_consumers=n_consumers,
                          **budgets)
    port = make_plan(TCfg(**kw), shapes, backend=backends[1],
                     n_queries=n_queries, n_consumers=n_consumers, **budgets)
    return ref, port


@pytest.mark.parametrize("case", [
    dict(backends=("jnp_gather", "torch_gather")),
    dict(backends=("pallas_windowed", "cuda_windowed"), table_dtype="int8"),
    dict(backends=("jnp_gather", "torch_gather"), n_queries=16,
         n_consumers=2),
], ids=["raster", "windowed_int8", "decode"])
def test_plan_snapshot_keeps_the_reference_keys(case):
    ref, port = _plan_pair(**case)
    rs, ts = ref.snapshot(), port.snapshot()
    assert set(ts) == set(rs)
    same = set(ts) - {"backend", "decode", "stream"}
    assert {k: ts[k] for k in same} == {k: rs[k] for k in same}
    assert ts["stream"] is None and rs["stream"] is None
    if rs["decode"] is None:
        assert ts["decode"] is None
    else:
        assert set(ts["decode"]) == set(rs["decode"])
        assert {k: rs["decode"][k] for k in ts["decode"]} == ts["decode"]
    json.dumps(ts)


def test_plan_describe_is_a_formatter_over_the_snapshot():
    _, plan = _plan_pair(("jnp_gather", "torch_gather"), n_queries=16,
                         n_consumers=2)
    snap, d = plan.snapshot(), plan.describe()
    assert plan.backend in d
    assert f"table={snap['value_table_bytes'] / 1024:.0f}KB" in d
    assert f"cache={snap['decode']['cache_table_bytes'] / 1024:.0f}KB" in d
    assert snap["decode"]["rebuild_bytes"] == 2 * plan.cache_table_bytes
