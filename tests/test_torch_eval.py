"""Detection evaluation of the port against the JAX reference, the toy
detector configs, ``get_detr_config``, and the card-by-default
``init_*`` entry points.

  * ``eval_detection_ap`` and ``_iou_cxcywh`` equal the reference's on
    seeded random logits, boxes and gt, and on the edge cases: no
    record, every score under 0.05, the ``top_n`` cut, an inactive gt, a
    class mismatch, no active gt; inputs as tensors or arrays;
  * the toy decoder detector's AP from converted reference params on the
    reference's images equals ``repro``'s ``detector_apply`` +
    ``eval_detection_ap``, and ``eval_ap`` agrees between ``auto`` and
    ``torch_gather`` on the CPU;
  * the toy configs equal ``benchmarks/detr_toy.py``'s field for field.

Tolerances: AP to 1e-12 (both are float64 sums of the same decisions;
the softmax is float32 on both sides, so the scores may differ by an
ulp, which moves no decision on these inputs); IoU to 1e-12."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core import detector as rdet  # noqa: E402
from repro.data import detection as rdata  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import detector as det  # noqa: E402
from repro_torch.data import detection as data  # noqa: E402
from repro_torch.train import detr  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _detr_toy():
    """The reference's benchmarks/detr_toy.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "ref_detr_toy", ROOT / "benchmarks" / "detr_toy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(seed, b=3, nq=40, c=4, m=3, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, nq, c + 1)) * scale).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, nq, 2)),
                            rng.uniform(0.1, 0.5, (b, nq, 2))],
                           -1).astype(np.float32)
    gt_box = boxes[:, :m].copy()
    gt_box[..., :2] += rng.normal(0, 0.03, (b, m, 2)).astype(np.float32)
    gt = {"cls": rng.integers(0, c, (b, m)).astype(np.int32),
          "box": gt_box,
          "active": np.arange(m)[None] < rng.integers(1, m + 1, (b, 1))}
    return logits, boxes, gt


def _both(logits, boxes, gt, **kw):
    want = rdata.eval_detection_ap(jnp.asarray(logits), jnp.asarray(boxes),
                                   {k: jnp.asarray(v) for k, v in gt.items()},
                                   **kw)
    got_np = data.eval_detection_ap(logits, boxes, gt, **kw)
    got_t = data.eval_detection_ap(
        torch.from_numpy(logits), torch.from_numpy(boxes),
        {k: torch.from_numpy(np.asarray(v)) for k, v in gt.items()}, **kw)
    return got_np, got_t, want


@pytest.mark.parametrize("seed", range(6))
def test_ap_equals_the_reference_on_random_cases(seed):
    logits, boxes, gt = _case(seed)
    got_np, got_t, want = _both(logits, boxes, gt)
    assert got_np == pytest.approx(want, abs=1e-12)
    assert got_t == pytest.approx(want, abs=1e-12)
    if seed == 0:
        assert want > 0.0


def test_ap_with_confident_true_positives():
    logits, boxes, gt = _case(10, scale=1.0)
    # make each active gt's own query confidently its class
    for b in range(logits.shape[0]):
        for m in range(gt["box"].shape[1]):
            logits[b, m, gt["cls"][b, m]] += 8.0
            boxes[b, m] = gt["box"][b, m]
    got_np, got_t, want = _both(logits, boxes, gt)
    assert got_np == got_t == pytest.approx(want, abs=1e-12)
    assert want > 0.5


@pytest.mark.parametrize("edge", ["no_record", "under_floor", "top_n",
                                  "inactive_gt", "class_mismatch",
                                  "no_active_gt", "iou_threshold"])
def test_ap_edge_cases_equal_the_reference(edge):
    logits, boxes, gt = _case(20, scale=1.0)
    kw = {}
    if edge == "no_record":                    # every score under the floor
        logits[:] = 0.0
        logits[..., -1] = 30.0
    elif edge == "under_floor":                # only a few above 0.05
        logits[..., -1] = 4.0
    elif edge == "top_n":
        logits[:, :, :4] += 5.0
        kw["top_n"] = 3
    elif edge == "inactive_gt":
        gt["active"][:, 1:] = False
        boxes[:, 1] = gt["box"][:, 1]
        for b in range(logits.shape[0]):
            logits[b, 1, gt["cls"][b, 1]] += 9.0
    elif edge == "class_mismatch":
        boxes[:, :3] = gt["box"]
        for b in range(logits.shape[0]):
            for m in range(3):
                logits[b, m, (gt["cls"][b, m] + 1) % 4] += 9.0
    elif edge == "no_active_gt":
        gt["active"][:] = False
    elif edge == "iou_threshold":
        kw["iou_thresh"] = 0.9
    got_np, got_t, want = _both(logits, boxes, gt, **kw)
    assert got_np == got_t == pytest.approx(want, abs=1e-12)
    if edge in ("no_record", "no_active_gt"):
        assert want == 0.0


def test_iou_equals_the_reference():
    rng = np.random.default_rng(4)
    pairs = rng.uniform(0.05, 0.9, (200, 2, 4))
    pairs[:20, 1] = pairs[:20, 0]                        # identical
    pairs[20:30, 1, :2] = pairs[20:30, 0, :2] + 5.0      # disjoint
    for a, b in pairs:
        want = rdata._iou_cxcywh(a, b)
        assert data._iou_cxcywh(a, b) == pytest.approx(want, abs=1e-12)
    assert data._iou_cxcywh(pairs[0, 0], pairs[0, 0]) == pytest.approx(1.0)
    assert data._iou_cxcywh(pairs[20, 0], pairs[20, 1]) == 0.0


# --------------------------------------------------------------------------
# the toy detector
# --------------------------------------------------------------------------

def _fields(cfg, skip=("dtype", "backend")):
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name in skip:
            continue
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def test_toy_configs_equal_the_reference():
    toy = _detr_toy()
    assert _fields(detr.toy_config()) == _fields(toy.toy_config())
    assert _fields(detr.toy_decoder_config()) == _fields(toy.toy_decoder_config())
    kw = dict(pap_mode="topk", pap_keep=6, act_bits=12)
    assert _fields(detr.with_attn(detr.toy_decoder_config(), **kw)) == \
        _fields(toy.with_attn(toy.toy_decoder_config(), **kw))
    cfg = detr.toy_decoder_config()
    assert (cfg.decoder.n_layers, cfg.decoder.n_queries, cfg.img_size,
            cfg.d_model, cfg.backbone_width) == (3, 24, 64, 64, 24)


def test_toy_detector_ap_equals_the_reference():
    toy = _detr_toy()
    rcfg, cfg = toy.toy_decoder_config(), detr.toy_decoder_config()
    key = jax.random.PRNGKey(5)
    r_params = jax.tree.map(np.asarray, rdet.init_detector(key, rcfg))
    params = params_from_numpy(r_params, device="cpu")
    aps = []
    for i in range(2):
        img, _, _, gt = rdata.synth_detection_batch(
            jax.random.fold_in(key, 100 + i), 4, rcfg.img_size,
            rcfg.level_shapes)
        r_cl, r_bx, _ = rdet.detector_apply(r_params, rcfg, img)
        want = rdata.eval_detection_ap(r_cl, r_bx, gt)
        with torch.no_grad():
            cl, bx, _ = det.detector_apply(
                params, cfg, torch.from_numpy(np.array(img)),
                backend="torch_gather")
        np.testing.assert_allclose(cl.numpy(), np.asarray(r_cl), rtol=1e-4,
                                   atol=1e-4)
        got = data.eval_detection_ap(
            cl, bx, {k: torch.from_numpy(np.array(v)) for k, v in gt.items()})
        assert got == pytest.approx(want, abs=1e-12)
        aps.append(got)
    assert any(a > 0 for a in aps)


def test_eval_ap_agrees_across_backends_on_the_cpu():
    cfg = detr.toy_decoder_config()
    params = det.init_detector(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(n_batches=2, batch=4)
    auto = detr.eval_ap(cfg, params, backend="auto", **kw)
    gather = detr.eval_ap(cfg, params, backend="torch_gather", **kw)
    assert auto == pytest.approx(gather, abs=1e-12)
    assert detr.eval_ap(cfg, params, backend="cuda_decode", **kw) == \
        pytest.approx(gather, abs=1e-12)


def test_cached_toy_round_trips_through_the_store(tmp_path):
    cache = str(tmp_path / "toy")
    cfg, trained = detr.train_toy_decoder_detector(
        steps=2, batch=2, device="cpu", cache=cache, log=lambda s: None)
    assert (tmp_path / "toy" / "step_00000002" / "manifest.json").exists()
    _, again = detr.train_toy_decoder_detector(
        steps=2, batch=2, device="cpu", cache=cache,
        log=lambda s: pytest.fail("trained again instead of loading"))
    from repro_torch.optim.adamw import tree_leaves
    for a, b in zip(tree_leaves(again), tree_leaves(trained)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# configs and the card-by-default entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["deformable-detr", "deformable-detr-defa",
                                  "dn-detr", "dino", "dino-defa"])
def test_get_detr_config_returns_the_family(name):
    mine, ref = configs.get_detr_config(name), rconfigs.get_detr_config(name)
    assert mine.name == ref.name == name
    assert mine.level_shapes == ref.level_shapes
    assert _fields(mine.encoder) == _fields(ref.encoder)
    assert mine.encoder.dtype == torch.bfloat16
    with pytest.raises(KeyError):
        configs.get_detr_config("no-such-detr")


def _init_calls():
    from repro_torch.core.encoder import EncoderConfig, init_encoder
    from repro_torch.core.msdeform_attn import (MSDeformAttnConfig,
                                                init_msdeform_attn)
    from repro_torch.msda.decoder import MSDADecoderConfig, init_decoder
    attn = MSDeformAttnConfig(d_model=32, n_heads=4)
    gen = lambda: torch.Generator().manual_seed(0)
    return {
        "init_msdeform_attn": lambda **kw: init_msdeform_attn(attn, gen(), **kw),
        "init_encoder": lambda **kw: init_encoder(
            EncoderConfig(attn=attn, n_blocks=1, d_ffn=64), gen(), **kw),
        "init_decoder": lambda **kw: init_decoder(
            MSDADecoderConfig(n_layers=1, n_queries=4, d_ffn=64), attn, gen(),
            **kw),
    }


@pytest.mark.parametrize("name", ["init_msdeform_attn", "init_encoder",
                                  "init_decoder"])
def test_init_functions_default_to_the_card(name):
    call = _init_calls()[name]
    from repro_torch.optim.adamw import tree_leaves
    leaves = tree_leaves(call(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in tree_leaves(call()))
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
