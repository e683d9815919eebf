"""The port's training pieces against the JAX reference: AdamW and its
schedule, the set matcher, the detection losses with their gradients,
the synthetic data's dense targets, one train step, and the autograd
guard of the forward-only kernels.

Sizes: the tiny decoder detector of tests/test_msda_decoder.py (d_model
32, 2 heads, 2 encoder blocks, 2 decoder layers of 12 queries, 32 px).

Tolerances:
  * AdamW, ``lr_at``: rtol 1e-6 (float32, the same operations);
  * matcher: exact;
  * losses and gradients: loss rtol 1e-5, gradients rtol 1e-4 / atol
    1e-5 (float32 sums in another order through two encoder blocks and
    the decoder). With DEFA on (PAP top-4, FWP compact, range narrowing,
    INT12) the same rule holds once the PAP picks and the FWP keep lists,
    checked first, are equal: the discrete decisions are what could make
    the two sides differ by more;
  * dense targets: exact;
  * one train step with pruning off: new params rtol 1e-4 / atol 1e-6
    where the gradient is not float roundoff (see the test)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import detector as rdet, encoder as renc  # noqa: E402
from repro.core import fwp as rfwp, pap as rpap  # noqa: E402
from repro.core import msdeform_attn as rattn  # noqa: E402
from repro.data import detection as rdata  # noqa: E402
from repro.msda import decoder as rdec  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import detector as det, encoder as enc  # noqa: E402
from repro_torch.core import fwp as fwp_lib, pap as pap_lib  # noqa: E402
from repro_torch.core import msdeform_attn as attn  # noqa: E402
from repro_torch.data import detection as data  # noqa: E402
from repro_torch.msda import decoder as dec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import detr as train  # noqa: E402

torch.set_num_threads(1)

TINY = dict(d_model=32, n_heads=2, n_levels=4, n_points=2)
PRUNING_OFF = {}
DEFA = dict(pap_mode="topk", pap_keep=4, fwp_mode="compact", fwp_k=1.0,
            fwp_capacity=0.6, range_narrow=(8.0, 6.0, 4.0, 3.0), act_bits=12,
            weight_bits=12)
KNOBS = {"plain": PRUNING_OFF, "defa": DEFA}


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

OPT_CASES = {
    "toy": dict(lr=2e-3, warmup_steps=10, total_steps=80, weight_decay=0.0),
    "clipped_decayed": dict(lr=1e-2, warmup_steps=2, total_steps=5,
                            clip_norm=0.05, weight_decay=0.1),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_three_updates_match_reference(case):
    rng = np.random.default_rng(0)
    tree = {"b": [rng.normal(size=(3, 4)).astype(np.float32),
                  {"w": rng.normal(size=(5,)).astype(np.float32)}],
            "a": rng.normal(size=(2, 2)).astype(np.float32)}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                          tree) for _ in range(3)]
    r_cfg = radamw.OptConfig(**OPT_CASES[case])
    cfg = adamw.OptConfig(**OPT_CASES[case])
    r_p, r_s = tree, radamw.adamw_init(tree)
    p = params_from_numpy(tree, device="cpu")
    s = adamw.adamw_init(p)
    for g in grads:
        r_p, r_s, r_m = radamw.adamw_update(r_p, g, r_s, r_cfg)
        p, s, m = adamw.adamw_update(p, params_from_numpy(g, device="cpu"), s,
                                     cfg)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(r_m[name]),
                                       rtol=1e-6)
    assert int(s["step"]) == int(r_s["step"]) == 3
    for got, want in ((p, r_p), (s["m"], r_s["m"]), (s["v"], r_s["v"])):
        got_l, want_l = adamw.tree_leaves(got), jax.tree.leaves(want)
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_lr_schedule_matches_reference(case):
    r_cfg = radamw.OptConfig(**OPT_CASES[case])
    cfg = adamw.OptConfig(**OPT_CASES[case])
    steps = np.arange(0, r_cfg.total_steps + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: radamw.lr_at(r_cfg, s))(steps))
    got = np.asarray([float(adamw.lr_at(cfg, int(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_tree_helpers_keep_structure_and_jax_leaf_order():
    tree = {"z": [torch.zeros(1), (torch.ones(2),)], "a": torch.full((3,), 2.0)}
    leaves = adamw.tree_leaves(tree)
    assert [x.numel() for x in leaves] == [3, 1, 2]    # dict keys sorted
    back = adamw.tree_unflatten(tree, leaves)
    assert list(back) == ["z", "a"] and isinstance(back["z"][1], tuple)
    doubled = adamw.tree_map(lambda x: 2 * x, tree)
    assert float(doubled["a"][0]) == 4.0


# --------------------------------------------------------------------------
# matcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_queries_matches_reference(matcher, seed):
    if matcher == "hungarian" and det._linear_sum_assignment is None:
        pytest.skip("scipy not installed (optional dependency)")
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 2, size=(3, 4, 7)).astype(np.float32)
    cost[0, 1, 2] = np.nan                                  # a diverged box
    cost[1, 0, :] = cost[1, 0, 0]                           # a tied row
    active = rng.uniform(size=(3, 4)) < 0.7
    active[:, 0] = True
    active[2] = False                                       # nothing active
    want = np.asarray(rdet.match_queries(jnp.asarray(cost), jnp.asarray(active),
                                         matcher))
    got = det.match_queries(_t(cost), _t(active), matcher)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_queries_rejects_an_unknown_matcher():
    with pytest.raises(ValueError, match="unknown matcher"):
        det.match_queries(torch.zeros((1, 1, 2)), torch.ones((1, 1), dtype=bool),
                          "auction")


# --------------------------------------------------------------------------
# losses and gradients
# --------------------------------------------------------------------------

def _cfgs(knobs, decoder, own_backend=None):
    kw = dict(TINY, **KNOBS[knobs])
    ref = rdet.DetectorConfig(
        encoder=renc.EncoderConfig(attn=rattn.MSDeformAttnConfig(**kw),
                                   n_blocks=2, d_ffn=64),
        img_size=32, n_classes=4, backbone_width=16,
        decoder=rdec.MSDADecoderConfig(n_layers=2, n_queries=12, d_ffn=64)
        if decoder else None)
    port = det.DetectorConfig(
        encoder=enc.EncoderConfig(attn=attn.MSDeformAttnConfig(
            **kw, backend=own_backend), n_blocks=2, d_ffn=64),
        img_size=32, n_classes=4, backbone_width=16,
        decoder=dec.MSDADecoderConfig(n_layers=2, n_queries=12, d_ffn=64)
        if decoder else None)
    return ref, port


def _ref_loss(cfg, params, batch):
    img, tc, tb, gt = batch
    if cfg.decoder is None:
        return rdet.detection_loss(params, cfg, img, tc, tb)
    return rdet.decoder_detection_loss(params, cfg, img, gt["cls"], gt["box"],
                                       gt["active"])


@functools.lru_cache(maxsize=None)
def _reference(knobs: str, decoder: bool):
    """Reference params, a synthetic batch, and the reference's loss and
    gradients under ``jax.value_and_grad`` (numpy)."""
    cfg, _ = _cfgs(knobs, decoder)
    key = jax.random.PRNGKey(3)
    params = jax.tree.map(np.asarray, rdet.init_detector(key, cfg))
    batch = jax.tree.map(np.asarray, rdata.synth_detection_batch(
        jax.random.fold_in(key, 1), 2, cfg.img_size, cfg.level_shapes))
    (loss, extras), grads = jax.jit(jax.value_and_grad(
        lambda p: _ref_loss(cfg, p, batch), has_aux=True))(params)
    return params, batch, float(loss), jax.tree.map(np.asarray, extras), \
        jax.tree.map(np.asarray, grads)


def _port_batch(batch):
    img, tc, tb, gt = batch
    return _t(img), _t(tc), _t(tb), {k: _t(v) for k, v in gt.items()}


class _Spy:
    """Records what one function returns, call by call."""

    def __init__(self, fn, pick):
        self.fn, self.pick, self.seen = fn, pick, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.seen.append(np.asarray(self.pick(out)))
        return out


def _assert_same_discrete_decisions(monkeypatch, knobs, decoder, params,
                                    batch, cfg, own):
    """Forward once on each side, recording every PAP pick and FWP keep
    list: the compared gradients must come from the same decisions."""
    ref_cfg, _ = _cfgs(knobs, decoder)
    spies = {}
    for label, mod_pap, mod_fwp in (("ref", rpap, rfwp),
                                    ("port", pap_lib, fwp_lib)):
        pap = _Spy(mod_pap.pap_select, lambda s: s.point_idx)
        keep = _Spy(mod_fwp.build_fwp_state, lambda s: s.keep_idx)
        monkeypatch.setattr(mod_pap, "pap_select", pap)
        monkeypatch.setattr(mod_fwp, "build_fwp_state", keep)
        spies[label] = (pap, keep)
    rdet.detector_apply(params, ref_cfg, batch[0])
    with torch.no_grad():
        det.detector_apply(params_from_numpy(params, device="cpu"), cfg,
                           _t(batch[0]), backend=own)
    monkeypatch.undo()
    for ref_spy, port_spy in zip(*spies.values()):
        assert len(ref_spy.seen) == len(port_spy.seen) > 0
        for a, b in zip(ref_spy.seen, port_spy.seen):
            np.testing.assert_array_equal(b, a)


LOSS_CASES = [("plain", False, None), ("defa", False, None),
              ("plain", True, None), ("defa", True, None),
              ("plain", True, "cuda_decode"), ("defa", True, "cuda_decode")]


@pytest.mark.parametrize("knobs,decoder,backend", LOSS_CASES,
                         ids=[f"{k}-{'decoder' if d else 'dense'}-{b or 'default'}"
                              for k, d, b in LOSS_CASES])
def test_losses_and_gradients_match_reference(monkeypatch, knobs, decoder,
                                              backend):
    """``backend="cuda_decode"`` trains the decoder through K2 (its plain
    forward and backward here) and the encoder through the config's own
    ``torch_gather``; the reference trains both through ``jnp_gather``."""
    params, batch, r_loss, r_extras, r_grads = _reference(knobs, decoder)
    own = "torch_gather" if backend else None
    _, cfg = _cfgs(knobs, decoder, own)
    if knobs == "defa":
        _assert_same_discrete_decisions(monkeypatch, knobs, decoder, params,
                                        batch, cfg, backend)
    tol = dict(loss=1e-5, rtol=1e-4, atol=1e-5)
    loss, extras, grads = train.loss_and_grads(
        params_from_numpy(params, device="cpu"), cfg, _port_batch(batch),
        backend=backend)
    np.testing.assert_allclose(float(loss), r_loss, rtol=tol["loss"])
    for name in ("cls_loss", "box_loss"):
        np.testing.assert_allclose(float(extras[name]), r_extras[name],
                                   rtol=tol["loss"])
    got_l, want_l = adamw.tree_leaves(grads), jax.tree.leaves(r_grads)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol["rtol"],
                                   atol=tol["atol"])
    if decoder:    # the decoder's sampling and the shared projection train
        assert float(grads["decoder"]["value"]["value_w"].abs().sum()) > 0
        for layer in grads["decoder"]["layers"]:
            assert float(layer["cross"]["offs_w"].abs().sum()) > 0


def test_clip_gradient_matches_jnp_clip_at_ties():
    """The range-narrowing clamp meets its bound exactly at init (the ring
    offset bias reaches the coarsest level's bound): there ``jnp.clip``
    passes half the gradient, ``torch.clamp`` all of it."""
    from repro_torch.core import nn
    x = np.asarray([-5.0, -4.0, -1.5, 4.0, 6.0, 0.25], np.float32)
    lo = np.asarray([-4.0, -4.0, -4.0, -4.0, -4.0, 0.25], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, lo, -lo) * jnp.arange(6.0)))(x)
    xt = _t(x).requires_grad_()
    (nn.clip(xt, _t(lo), -_t(lo)) * torch.arange(6.0)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(nn.clip(_t(x), _t(lo), -_t(lo)).numpy(),
                                  np.clip(x, lo, -lo))


def test_encoder_backend_routes_decode_only_requests():
    assert det.encoder_backend("cuda_decode") == "auto"
    assert det.encoder_backend("cuda_decode", "torch_gather") == "torch_gather"
    assert det.encoder_backend("cuda_decode", "auto") == "auto"
    assert det.encoder_backend("cuda_decode", "cuda_decode") == "auto"
    assert det.encoder_backend("cuda_fused", "torch_gather") == "cuda_fused"
    assert det.encoder_backend(None, "torch_gather") is None
    cfg = train.train_config(img_size=64, n_blocks=1, n_layers=1)
    assert cfg.encoder.attn.backend == "torch_gather"
    assert det.decoder_plan(cfg, "cuda_decode").backend == "cuda_decode"


# --------------------------------------------------------------------------
# synthetic data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dense_targets_match_reference_for_its_boxes(seed):
    """The reference's draws, through the port's deterministic targets."""
    levels = ((16, 16), (8, 8), (4, 4), (2, 2))
    _, tc, tb, gt = jax.tree.map(np.asarray, rdata.synth_detection_batch(
        jax.random.PRNGKey(seed), 3, 64, levels))
    box = _t(gt["box"])
    got_c, got_b = data.dense_targets(box[..., :2], box[..., 2:], _t(gt["cls"]),
                                      _t(gt["active"]), levels)
    np.testing.assert_array_equal(got_c.numpy(), tc)
    np.testing.assert_array_equal(got_b.numpy(), tb)


def test_synth_batch_is_seeded_and_lands_on_the_device():
    levels = ((8, 8), (4, 4), (2, 2), (1, 1))
    one = data.synth_detection_batch(torch.Generator().manual_seed(5), 2, 32,
                                     levels, device="cpu")
    two = data.synth_detection_batch(torch.Generator().manual_seed(5), 2, 32,
                                     levels, device="cpu")
    img, tc, tb, gt = one
    assert img.shape == (2, 3, 32, 32) and tc.shape == (2, 85)
    assert tb.shape == (2, 85, 4) and bool(gt["active"][:, 0].all())
    torch.testing.assert_close(img, two[0], rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            data.synth_detection_batch(torch.Generator(), 1, 32, levels)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "cuda_decode"])
def test_train_step_matches_reference_step_fn(backend):
    """The reference's ``step_fn`` (benchmarks/detr_toy.py:96-104): value
    and grad of ``decoder_detection_loss``, then ``adamw_update``.

    Adam divides each gradient by sqrt(v) + eps: where the gradient is
    float roundoff (|g| <= 1e-7; the self-attention key bias, which the
    softmax leaves exactly gradient-free, has |g| ~ 1e-9), the first step
    turns that noise into a step of up to lr, on either side. Those
    entries are held to the step's bound |delta| <= lr, the rest to
    rtol 1e-4 / atol 1e-6."""
    params, batch, _, _, r_grads = _reference("plain", True)
    ref_cfg, cfg = _cfgs("plain", True, "torch_gather" if backend else None)
    kw = dict(lr=2e-3, warmup_steps=10, total_steps=400, weight_decay=0.0)
    r_opt_cfg = radamw.OptConfig(**kw)

    @jax.jit
    def step_fn(params, opt, img, gc, gb, ga):
        (loss, _), grads = jax.value_and_grad(
            rdet.decoder_detection_loss, has_aux=True)(params, ref_cfg, img,
                                                      gc, gb, ga)
        params, opt, _ = radamw.adamw_update(params, grads, opt, r_opt_cfg)
        return params, opt, loss

    img, _, _, gt = batch
    r_params, _, r_loss = step_fn(params, radamw.adamw_init(params), img,
                                  gt["cls"], gt["box"], gt["active"])
    p = params_from_numpy(params, device="cpu")
    new, opt, metrics, _ = train.train_step(
        p, adamw.adamw_init(p), _port_batch(batch), cfg,
        adamw.OptConfig(**kw), backend=backend)
    assert int(opt["step"]) == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(r_loss), rtol=1e-5)
    lr = float(metrics["lr"])
    n_roundoff = 0
    for a, b, g, p0 in zip(adamw.tree_leaves(new), jax.tree.leaves(r_params),
                           jax.tree.leaves(r_grads), jax.tree.leaves(params)):
        a, b = a.numpy(), np.asarray(b)
        roundoff = np.abs(g) <= 1e-7
        n_roundoff += int(roundoff.sum())
        np.testing.assert_allclose(a[~roundoff], b[~roundoff], rtol=1e-4,
                                   atol=1e-6)
        assert np.all(np.abs(a - p0)[roundoff] <= lr * (1 + 1e-6))
    assert n_roundoff < 0.1 * sum(x.size for x in jax.tree.leaves(params))


def test_train_detector_runs_on_the_cpu():
    cfg = train.train_config(img_size=32, n_blocks=1, n_layers=1, n_queries=8)
    params, history = train.train_detector(
        cfg, 2, 1, torch.Generator().manual_seed(0), device="cpu",
        log=lambda _: None)
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in history)
    assert params["decoder"]["layers"][0]["cross"]["offs_w"].abs().sum() > 0


# --------------------------------------------------------------------------
# forward-only kernels refuse autograd
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda_fused", "cuda_windowed"])
def test_forward_only_backends_raise_under_autograd(backend):
    from repro_torch import msda
    levels = ((8, 8), (4, 4), (2, 2), (1, 1))
    cfg = attn.MSDeformAttnConfig(**dict(TINY, range_narrow=(3.0, 2.0, 1.5, 1.0)))
    params = attn.init_msdeform_attn(cfg, torch.Generator().manual_seed(0))
    n_in = sum(h * w for h, w in levels)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, n_in, 32), generator=g)
    refs = torch.rand((1, n_in, 2), generator=g)
    plan = msda.make_plan(cfg, levels, backend=backend)
    with torch.no_grad():
        out, _ = msda.msda_attention(params, plan, x, refs, x)
    assert out.shape == (1, n_in, 32)
    x.requires_grad_()
    with pytest.raises(RuntimeError, match="torch_gather"):
        msda.msda_attention(params, plan, x, refs, x)
    with torch.inference_mode():
        msda.msda_attention(params, plan, x.detach(), refs, x.detach())
