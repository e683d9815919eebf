"""The port's serving engines prepared ahead of time, with telemetry, on
the CPU.

``DetrServeEngine`` prepares every bucket at construction (on the card a
CUDA-graph capture, here the same warm-up forward), so ``compile_count``
equals the number of buckets and never moves under load; its telemetry
carries the reference's metric names, counts admitted, rejected and
completed requests, one latency observation per completed request and a
``plan`` event per bucket; with ``Observability.disabled()`` it serves
the same bits with an empty registry; a forward after the first builds
no host constant. ``ServeEngine`` prepares its decode step once, updates
``pos`` and ``last_tok`` in place (a graph reads fixed addresses) and
still gives the reference's greedy tokens.

Small detector: d_model 32, 2 heads, 1 encoder block, 2 decoder layers
of 8 queries, buckets of 32 and 64 px. Outputs of two engines on the
same inputs are compared bit for bit (same code, same device)."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.bridge import host_constant_misses  # noqa: E402
from repro_torch.core.detector import DetectorConfig, init_detector  # noqa: E402
from repro_torch.core.encoder import EncoderConfig  # noqa: E402
from repro_torch.core.msdeform_attn import MSDeformAttnConfig  # noqa: E402
from repro_torch.msda.decoder import MSDADecoderConfig  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.obs.obs import OBS_JSONL_ENV  # noqa: E402
from repro_torch.serve import DetrRequest, DetrServeEngine  # noqa: E402

torch.set_num_threads(1)

#: the reference engine's metric names (repro/serve/engine.py:97-125,
#: repro/serve/postproc.py:96-112)
REFERENCE_METRICS = {
    "msda_compiles_total": "counter", "serve_requests_total": "counter",
    "serve_queue_depth": "gauge", "serve_postproc_backlog": "gauge",
    "serve_request_latency_seconds": "histogram",
    "serve_span_seconds": "histogram", "staged_bytes_total": "counter",
    "serve_postproc_items_total": "counter"}


def _cfg(backend=None):
    attn = MSDeformAttnConfig(d_model=32, n_heads=2, n_levels=4, n_points=2,
                              fwp_mode="compact", fwp_k=1.0, fwp_capacity=0.6,
                              range_narrow=(8.0, 6.0, 4.0, 3.0), backend=backend)
    return DetectorConfig(
        encoder=EncoderConfig(attn=attn, n_blocks=1, d_ffn=64), img_size=32,
        n_classes=3, backbone_width=8,
        decoder=MSDADecoderConfig(n_layers=2, n_queries=8, d_ffn=32))


def _params(cfg):
    return init_detector(cfg, torch.Generator().manual_seed(1), device="cpu")


def _images(n, size, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (3, size, size)).astype(np.float32)
            for _ in range(n)]


def _engine(obs=None, **kw):
    """``auto``: K1 in the encoder, K2 in the decoder, as on the card
    (here their plain versions)."""
    cfg = _cfg()
    kw.setdefault("resolutions", (32, 64))
    kw.setdefault("backend", "auto")
    return DetrServeEngine(cfg, _params(cfg), max_batch=2, obs=obs,
                           device="cpu", **kw)


def _mixed_load():
    """Exact fits in both buckets and two pad-ups."""
    im64 = _images(2, 64, seed=3)
    return _images(3, 32) + im64 + [im64[0][:, :20, :28].copy(),
                                    im64[1][:, :40, :64].copy()]


def test_compile_count_equals_buckets_and_stays_flat_under_mixed_load():
    with _engine(obs=Observability.create()) as engine:
        assert engine.compile_count == len(engine.buckets) == 2
        m = engine.obs.metrics.get("msda_compiles_total")
        assert m.value(bucket="32") == 1 and m.value(bucket="64") == 1
        for i, im in enumerate(_mixed_load()):
            assert engine.submit(DetrRequest(rid=i, image=im))
        done = engine.run_until_drained()
        assert len(done) == 7
        assert engine.compile_count == 2 and m.total() == 2
        assert sorted(r.bucket for r in done) == [32] * 4 + [64] * 3
        for r in done:
            assert r.cls_probs.shape == (8, 4) and np.isfinite(r.cls_probs).all()


def test_requests_counted_admitted_rejected_completed_with_latency():
    with _engine(obs=Observability.create()) as engine:
        m = engine.obs.metrics
        assert {n: m.get(n).kind for n in REFERENCE_METRICS} == REFERENCE_METRICS
        load = _mixed_load()
        for i, im in enumerate(load):
            assert engine.submit(DetrRequest(rid=i, image=im))
        assert m.value("serve_queue_depth", bucket="32") == 4
        big = DetrRequest(rid=99, image=np.zeros((3, 100, 100), np.float32))
        assert not engine.submit(big)
        engine.run_until_drained()
        req = m.get("serve_requests_total")
        assert req.value(bucket="none", outcome="rejected") == 1
        for b, n in (("32", 4), ("64", 3)):
            assert req.value(bucket=b, outcome="admitted") == n
            assert req.value(bucket=b, outcome="completed") == n
            assert m.value("serve_queue_depth", bucket=b) == 0
        lat = m.get("serve_request_latency_seconds")
        assert lat.total_count() == len(engine.finished) == len(load)
        assert lat.count(bucket="32") == 4 and lat.count(bucket="64") == 3
        stats = engine.obs.tracer.span_stats()
        assert stats["queue"]["count"] == len(load)
        batches = engine.batches_dispatched
        assert stats["device"]["count"] == stats["postproc"]["count"] == batches
        assert m.get("serve_postproc_items_total").total() == batches
        assert m.value("serve_postproc_backlog") == 0
        # two batches per bucket: 4 requests at 32 px, 3 at 64 px
        assert batches == 4
        assert m.value("staged_bytes_total", mode="build") == 2 * sum(
            b.plan.cache_table_bytes for b in engine.buckets)


def test_callbacks_run_inside_callback_spans():
    seen = []
    with _engine(obs=Observability.create()) as engine:
        for i, im in enumerate(_images(3, 32)):
            assert engine.submit(DetrRequest(rid=i, image=im,
                                             callback=lambda r: seen.append(r.rid)))
        engine.run_until_drained()
        assert sorted(seen) == [0, 1, 2]
        assert engine.obs.tracer.span_stats()["callback"]["count"] == 3


def test_disabled_engine_serves_bit_identically_with_empty_registry():
    load = _mixed_load()
    results = []
    for obs in (Observability.create(), Observability.disabled()):
        with _engine(obs=obs) as engine:
            for i, im in enumerate(load):
                assert engine.submit(DetrRequest(rid=i, image=im))
            results.append({r.rid: r for r in engine.run_until_drained()})
            if not obs.enabled:
                assert engine.obs.metrics.snapshot() == {
                    "counters": {}, "gauges": {}, "histograms": {}}
                assert engine.compile_count == 0      # the null counter reads 0
    on, off = results
    assert set(on) == set(off) == set(range(len(load)))
    for rid in on:
        np.testing.assert_array_equal(on[rid].cls_probs, off[rid].cls_probs)
        np.testing.assert_array_equal(on[rid].boxes, off[rid].boxes)
        np.testing.assert_array_equal(on[rid].detections["scores"],
                                      off[rid].detections["scores"])


def test_served_outputs_equal_the_public_eager_forward():
    """What a request gets back is the eager forward of its padded batch
    (here the engine's path; on the card the graph's, held to the same
    forward in tests/test_torch_cuda.py)."""
    imgs = _images(2, 32)
    with _engine(resolutions=(32,), pipeline_postproc=False) as engine:
        for i, im in enumerate(imgs):
            assert engine.submit(DetrRequest(rid=i, image=im))
        done = {r.rid: r for r in engine.run_until_drained()}
        cls, boxes, _ = engine.forward(torch.from_numpy(np.stack(imgs)), 32)
    for i in range(2):
        np.testing.assert_array_equal(done[i].boxes, boxes[i].numpy())
        np.testing.assert_allclose(done[i].cls_probs,
                                   torch.softmax(cls[i], -1).numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_second_forward_builds_no_host_constant():
    """Every tensor built from host values (level geometry, position
    tables, bounds, scalars) is built once per shape: a forward after the
    first makes no host-to-device copy of its own."""
    cfg = _cfg()
    with DetrServeEngine(cfg, _params(cfg), max_batch=2, resolutions=(32,),
                         backend="auto", device="cpu") as engine:
        built = host_constant_misses()
        x = torch.from_numpy(np.stack(_images(2, 32)))
        engine.forward(x, 32)
        engine.forward(x, 32)
        assert host_constant_misses() == built
        for i, im in enumerate(_images(2, 32, seed=5)):
            engine.submit(DetrRequest(rid=i, image=im))
        engine.run_until_drained()
        assert host_constant_misses() == built


def test_plan_events_and_bucket_table(tmp_path, monkeypatch):
    path = str(tmp_path / "serve.jsonl")
    monkeypatch.setenv(OBS_JSONL_ENV, path)
    engine = _engine()                                  # obs=None -> env sink
    for i, im in enumerate(_images(2, 32)):
        engine.submit(DetrRequest(rid=i, image=im))
    engine.run_until_drained()
    table = engine.bucket_table()
    assert [row["resolution"] for row in table] == [32, 64]
    assert all(row["backend"] == "cuda_decode" for row in table)
    assert "bucket 32px" in engine.describe() and "cuda_decode" in engine.describe()
    engine.close()
    events = [json.loads(line) for line in open(path)]
    plans = [e for e in events if e["type"] == "plan"]
    assert sorted(p["bucket"] for p in plans) == [32, 64]
    assert plans[0]["plan"]["backend"] == "cuda_decode"
    assert plans[0]["plan"]["decode"]["n_queries"] == 8
    from repro_torch.obs.validate import main
    assert main(["--jsonl", path, "--require", "msda_compiles_total",
                 "serve_requests_total"]) == 0


# --------------------------------------------------------------------------
# the LM token server
# --------------------------------------------------------------------------

def test_lm_engine_updates_state_in_place_and_matches_the_reference():
    from repro.serve import lm as ref_lm
    from repro_torch.serve import lm
    from tests.test_torch_lm import _decoder_pair, _requests
    rcfg, tcfg, p, tp = _decoder_pair("minitron-4b")
    ref = ref_lm.ServeEngine(rcfg, p, ref_lm.ServeConfig(max_batch=2,
                                                         cache_len=32))
    for r in _requests(ref_lm):
        ref.submit(r)
    want = {r.rid: r.output for r in ref.run_until_drained()}
    eng = lm.ServeEngine(tcfg, tp, lm.ServeConfig(max_batch=2, cache_len=32),
                         device="cpu")
    assert eng.compile_count == 1
    ptrs = (eng.pos.data_ptr(), eng.last_tok.data_ptr(),
            {k: v.data_ptr() for k, v in eng.cache.items()})
    for r in _requests(lm):
        eng.submit(r)
    while eng.queue or eng.active.any():
        eng.step()
        assert (eng.pos.data_ptr(), eng.last_tok.data_ptr(),
                {k: v.data_ptr() for k, v in eng.cache.items()}) == ptrs
    assert {r.rid: r.output for r in eng.finished} == want
    assert eng.compile_count == 1


def test_lm_engine_sampling_stays_outside_the_prepared_step():
    """Sampled decoding draws from ``gen`` on the host side of the step:
    two engines seeded alike agree, and the preparation count stays 1."""
    from repro_torch.serve import lm
    from tests.test_torch_lm import _decoder_pair, _requests
    _, tcfg, _, tp = _decoder_pair("minitron-4b")
    outs = []
    for _ in range(2):
        eng = lm.ServeEngine(tcfg, tp, lm.ServeConfig(
            max_batch=2, cache_len=32, greedy=False, temperature=0.7),
            torch.Generator().manual_seed(11), device="cpu")
        for r in _requests(lm):
            eng.submit(r)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
        assert eng.compile_count == 1
    assert outs[0] == outs[1]


def test_pad_batch_zeroes_padding_and_idle_slots():
    from repro_torch.serve.engine import pad_batch
    dst = np.full((3, 3, 4, 4), 7.0, np.float32)
    a = np.ones((3, 4, 4), np.float32)
    b = np.full((3, 2, 3), 2.0, np.float32)
    pad_batch(dst, [a, b])
    assert (dst[0] == 1).all() and (dst[2] == 0).all()
    assert (dst[1, :, :2, :3] == 2).all() and dst[1].sum() == 2 * 3 * 6
