"""The port's model against the JAX reference: ``detector_apply`` with both
heads (dense per-pixel and the deformable-DETR decoder) against the
reference's jitted ``detector_apply`` on converted reference params, the
int8-table DEFA detector through ``cuda_windowed`` against the
reference's ``pallas_windowed`` (interpret mode), and the port's
``DetrServeEngine`` on the CPU.

Sizes: d_model 64, 4 heads, 2 encoder blocks, 2 decoder layers of 30
queries, 64 px images (levels 16², 8², 4², 2²).

Tolerances:
  * no pruning or quantization: rtol = atol = 1e-5 — float32 end to end;
    the frameworks only reassociate conv/matmul sums (measured ~2e-6);
  * DEFA knobs (PAP top-4, FWP compact, range narrowing, INT12): a
    float-ulp difference can move a fake-quant value across a rounding
    boundary (one 12-bit quantum) or flip a top-k pick, so the outputs
    may differ by a few quanta where that happens and nowhere else:
    max |diff| <= 2e-3 (logits are O(1)) and median |diff| <= 1e-5."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import detector as rdet, encoder as renc  # noqa: E402
from repro.core import msdeform_attn as rattn  # noqa: E402
from repro.msda import decoder as rdec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import detector as det, encoder as enc  # noqa: E402
from repro_torch.core import msdeform_attn as attn  # noqa: E402
from repro_torch.msda import decoder as dec  # noqa: E402
from repro_torch.serve import DetrRequest, DetrServeEngine, StarvationError  # noqa: E402

torch.set_num_threads(1)

DEFA = dict(pap_mode="topk", pap_keep=4, fwp_mode="compact", fwp_capacity=0.6,
            range_narrow=(16.0, 12.0, 8.0, 4.0), act_bits=12, weight_bits=12)


def _cfgs(defa: bool, decoder: bool, table=None):
    kw = dict(d_model=64, n_heads=4, table_dtype=table,
              **(DEFA if defa else {}))
    ref = rdet.DetectorConfig(
        encoder=renc.EncoderConfig(attn=rattn.MSDeformAttnConfig(**kw),
                                   n_blocks=2, d_ffn=128),
        img_size=64, decoder=rdec.MSDADecoderConfig(
            n_layers=2, n_queries=30, d_ffn=128) if decoder else None)
    port = det.DetectorConfig(
        encoder=enc.EncoderConfig(attn=attn.MSDeformAttnConfig(**kw),
                                  n_blocks=2, d_ffn=128),
        img_size=64, decoder=dec.MSDADecoderConfig(
            n_layers=2, n_queries=30, d_ffn=128) if decoder else None)
    return ref, port


@functools.lru_cache(maxsize=None)
def _case(defa: bool, decoder: bool, table=None, ref_backend=None):
    ref_cfg, cfg = _cfgs(defa, decoder, table)
    params = jax.tree.map(np.asarray, rdet.init_detector(jax.random.PRNGKey(0),
                                                         ref_cfg))
    images = np.random.default_rng(0).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    cls, boxes, _ = jax.jit(lambda p, x: rdet.detector_apply(
        p, ref_cfg, x, backend=ref_backend))(params, images)
    return cfg, params, images, np.asarray(cls), np.asarray(boxes)


def _assert_defa_close(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= 2e-3 and np.median(diff) <= 1e-5, \
        (diff.max(), np.median(diff))


@pytest.mark.parametrize("backend", ["auto", "torch_gather"])
@pytest.mark.parametrize("decoder", [False, True], ids=["dense_head", "decoder"])
@pytest.mark.parametrize("defa", [False, True], ids=["plain", "defa"])
def test_detector_apply_matches_reference(defa, decoder, backend):
    cfg, params, images, r_cls, r_boxes = _case(defa, decoder)
    cls, boxes, aux = det.detector_apply(params_from_numpy(params, "cpu"), cfg,
                                         torch.from_numpy(images),
                                         backend=backend)
    nq = 30 if decoder else sum(h * w for h, w in cfg.level_shapes)
    assert cls.shape == (2, nq, 5) and boxes.shape == (2, nq, 4)
    assert len(aux["blocks"]) == 2
    for got, want in ((cls.numpy(), r_cls), (boxes.numpy(), r_boxes)):
        if defa:
            _assert_defa_close(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _Spy:
    """Counts the calls of one kernel wrapper (on CPU tensors each call
    runs the kernel's plain version)."""

    def __init__(self, monkeypatch, module, attr):
        self.calls = 0
        orig = getattr(module, attr)

        def spy(*args, **kwargs):
            self.calls += 1
            return orig(*args, **kwargs)
        monkeypatch.setattr(module, attr, spy)


def _spies(monkeypatch):
    from repro_torch.kernels import msgs_decode, msgs_fused, msgs_windowed
    return {"msgs_windowed": _Spy(monkeypatch, msgs_windowed,
                                  "msgs_windowed_msp"),
            "msgs_decode": _Spy(monkeypatch, msgs_decode, "msgs_decode"),
            "msgs_fused": _Spy(monkeypatch, msgs_fused, "msgs_fused")}


@pytest.mark.parametrize("decoder", [False, True], ids=["dense_head", "decoder"])
def test_int8_windowed_detector_matches_reference(decoder, monkeypatch):
    """The 1024 px slice's path at toy size: DEFA, int8 value table, the
    encoder through ``cuda_windowed`` against the reference's
    ``pallas_windowed``; the decoder head degrades the raster-only request
    to ``auto`` on both sides (``cuda_decode`` / ``pallas_decode``) on the
    int8 staged table."""
    cfg, params, images, r_cls, r_boxes = _case(True, decoder, "int8",
                                                "pallas_windowed")
    if decoder:
        plan = det.decoder_plan(cfg, "cuda_windowed")
        assert plan.backend == "cuda_decode" and plan.table_dtype == "int8"
    spies = _spies(monkeypatch)
    cls, boxes, _ = det.detector_apply(params_from_numpy(params, "cpu"), cfg,
                                       torch.from_numpy(images),
                                       backend="cuda_windowed")
    assert {k: s.calls for k, s in spies.items()} == {
        "msgs_windowed": 2, "msgs_decode": 2 if decoder else 0,
        "msgs_fused": 0}
    for got, want in ((cls.numpy(), r_cls), (boxes.numpy(), r_boxes)):
        _assert_defa_close(got, want)


def test_default_device_detector_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default runs there")
    _, cfg = _cfgs(True, True)
    with pytest.raises(RuntimeError, match="cuda"):
        det.init_detector(cfg)


def _engine(pipelined: bool, backend="auto"):
    cfg, params, *_ = _case(True, True)
    return DetrServeEngine(cfg, params_from_numpy(params, "cpu"), max_batch=2,
                           backend=backend, device="cpu",
                           pipeline_postproc=pipelined)


@pytest.mark.parametrize("pipelined", [True, False])
def test_serve_engine_answers_requests_like_detector_apply(pipelined):
    cfg, params, images, *_ = _case(True, True)
    rng = np.random.default_rng(1)
    imgs = [rng.normal(size=(3, 64, 64)).astype(np.float32) for _ in range(3)]
    with _engine(pipelined) as eng:
        reqs = [DetrRequest(rid=i, image=im) for i, im in enumerate(imgs)]
        big = DetrRequest(rid=99, image=np.zeros((3, 96, 96), np.float32))
        assert all(eng.submit(r) for r in reqs)
        assert not eng.submit(big) and "exceeds the largest bucket" in big.error
        done = eng.run_until_drained()
        assert eng.batches_dispatched == 2
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert eng.rejected == [big]
    p = params_from_numpy(params, "cpu")
    batch = torch.from_numpy(np.stack([imgs[2], np.zeros_like(imgs[2])]))
    cls, boxes, _ = det.detector_apply(p, cfg, torch.from_numpy(
        np.stack(imgs[:2])), backend="auto")
    cls2, boxes2, _ = det.detector_apply(p, cfg, batch, backend="auto")
    want_cls = torch.cat([cls, cls2[:1]]).softmax(-1).numpy()
    want_boxes = torch.cat([boxes, boxes2[:1]]).numpy()
    for r in reqs:
        assert r.done and r.cls_probs.shape == (30, 5) and r.boxes.shape == (30, 4)
        np.testing.assert_allclose(r.cls_probs, want_cls[r.rid], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r.boxes, want_boxes[r.rid], rtol=1e-5,
                                   atol=1e-6)
        assert len(r.detections["scores"]) == 5


def test_serve_engine_answers_through_cuda_windowed(monkeypatch):
    """An int8-table engine asked for ``cuda_windowed`` answers like
    ``detector_apply`` through the same backend, each batch sampling the
    encoder through K3 and the decoder through K2. Construction runs one
    warm-up forward of the bucket through the same kernels."""
    cfg, params, *_ = _case(True, True, "int8", "pallas_windowed")
    rng = np.random.default_rng(2)
    imgs = [rng.normal(size=(3, 64, 64)).astype(np.float32) for _ in range(2)]
    spies = _spies(monkeypatch)
    per_forward = {"msgs_windowed": 2, "msgs_decode": 2, "msgs_fused": 0}
    with DetrServeEngine(cfg, params_from_numpy(params, "cpu"), max_batch=2,
                         backend="cuda_windowed", device="cpu") as eng:
        assert {k: s.calls for k, s in spies.items()} == per_forward
        reqs = [DetrRequest(rid=i, image=im) for i, im in enumerate(imgs)]
        assert all(eng.submit(r) for r in reqs)
        eng.run_until_drained()
        assert eng.batches_dispatched == 1
    assert {k: s.calls for k, s in spies.items()} == {
        k: 2 * n for k, n in per_forward.items()}
    cls, boxes, _ = det.detector_apply(
        params_from_numpy(params, "cpu"), cfg, torch.from_numpy(np.stack(imgs)),
        backend="cuda_windowed")
    for r in reqs:
        assert r.done and r.cls_probs.shape == (30, 5)
        np.testing.assert_allclose(r.cls_probs, cls.softmax(-1)[r.rid].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r.boxes, boxes[r.rid].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_serve_engine_starvation_and_close():
    eng = _engine(True)
    eng.submit(DetrRequest(rid=0, image=np.zeros((3, 64, 64), np.float32)))
    with pytest.raises(StarvationError) as err:
        eng.run_until_drained(max_steps=0)
    assert err.value.report["queued"] == {64: 1}
    assert len(eng.run_until_drained()) == 1
    eng.close()
    eng.close()                                   # idempotent
    eng.submit(DetrRequest(rid=1, image=np.zeros((3, 64, 64), np.float32)))
    with pytest.raises(RuntimeError, match="closed"):
        eng.step()
