"""The train steps as CUDA-graph bodies (``repro_torch/train/step.py``
``build_train_step``, ``utils/graphs.py``, ``optim/adamw.py``
``adamw_update_``, the detector's loss split at its host matcher), on the
CPU, where every body runs eagerly exactly as the card captures it:

  * the three-stage ``decoder_detection_loss`` (device stage, host
    matcher, loss stage) equals the composition it replaced, bitwise in
    value and in every gradient;
  * the step keeps the address of every leaf of params, moments and step
    counts over 3 steps, bitwise the functional step (``value_and_grad``
    and the functional ``adamw_update``; ``detr.train_step`` for the
    detector); a fresh state handed to the step lands in its standing
    state; ``restore_into(..., in_place=True)`` writes the saved values
    into the template's tensors;
  * no body reads the device from the host (``Tensor.item``, ``tolist``,
    ``__bool__``, ``__int__``, ``__float__``, ``.cpu()`` and ``.numpy()``
    raise while one runs) for every LM family the train launcher takes
    and every detector head; only the matcher's host stage, which lies
    between the bodies, reads the cost; an injected read raises;
  * the captured-API step runs 3 steps against the reference's **jitted**
    steps: ``jax.jit(build_train_step(cfg, opt))`` on deepseek-7b SMOKE
    at accum 1 and 2, and the toy decoder detector's ``step_fn``
    (benchmarks/detr_toy.py:98) rebuilt here on the tiny detector of
    tests/test_torch_train.py.

Tolerances: bitwise where the port is compared with itself; against the
reference those of ``test_torch_train_loop.py::
test_train_step_matches_the_reference``: loss (and ce, grad_norm, lr)
rtol 1e-5, params and first moments rtol = atol = 5e-4. For the detector,
an element whose every gradient was float roundoff (the reference's
first moment |m| <= 1e-7 after 3 steps) is held instead to AdamW's step
bound, |delta| <= 2 x the sum of the 3 learning rates: Adam turns such
noise into a step of up to lr on either side (see
test_torch_train.py::test_train_step_matches_the_reference)."""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_train as tcases  # noqa: E402
from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.core import detector as rdet  # noqa: E402
from repro.data import detection as rdata  # noqa: E402
from repro.data import tokens as rtokens  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import detector as det  # noqa: E402
from repro_torch.data.tokens import TokenDataConfig  # noqa: E402
from repro_torch.launch.train import train_batch  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: E402
                                     adamw_update, tree_leaves,
                                     tree_unflatten)
from repro_torch.train import detr  # noqa: E402
from repro_torch.train.step import (TrainState, _loss_and_grads,  # noqa: E402
                                    build_train_step, make_train_state)
from repro_torch.utils.graphs import CapturedGraphs  # noqa: E402

torch.set_num_threads(1)

LM_CFG = dataclasses.replace(get_smoke_config("deepseek-7b"))
LM_DATA = TokenDataConfig(vocab_size=LM_CFG.vocab_size, seq_len=16,
                          global_batch=4, seed=2)
OPT_KW = dict(lr=1e-2, warmup_steps=2, total_steps=50, weight_decay=0.1)
TOY_OPT_KW = dict(lr=2e-3, warmup_steps=10, total_steps=400, weight_decay=0.0)
#: one detector per head and matcher; the tiny config of test_torch_train
DETECTORS = {"decoder_hungarian": (True, "hungarian"),
             "decoder_greedy": (True, "greedy"), "dense": (False, None)}
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "cpu",
              "numpy")


def _leaves(state):
    return tree_leaves(tuple(state))


def _assert_bitwise(a, b):
    a, b = tree_leaves(a), tree_leaves(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _lm_state(cfg=LM_CFG):
    return make_train_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _lm_batch(step, cfg=LM_CFG, data=LM_DATA):
    return train_batch(cfg, data, step, "cpu")


def _detector(name):
    decoder, _ = DETECTORS[name]
    _, cfg = tcases._cfgs("plain", decoder, "torch_gather")
    return cfg


@contextlib.contextmanager
def _matcher(name):
    """The matcher the detector case runs: greedy by forcing scipy out."""
    if DETECTORS[name][1] != "greedy":
        yield
        return
    saved = det._linear_sum_assignment
    det._linear_sum_assignment = None
    try:
        yield
    finally:
        det._linear_sum_assignment = saved


def _detector_batch(cfg, step):
    return detr.detection_batches(cfg, 2, seed=4, device="cpu")(step)


# --------------------------------------------------------------------------
# the detector's loss in three stages
# --------------------------------------------------------------------------

def _composition_it_replaced(params, cfg, images, gt_cls, gt_box, gt_active,
                             matcher=None):
    """decoder_detection_loss as one function, before the split."""
    cls_logits, boxes, _ = det.detector_apply(params, cfg, images)
    _, nq, _ = cls_logits.shape
    cost = torch.sum(torch.abs(boxes[:, None] - gt_box[:, :, None]), -1)
    owner = det.match_queries(cost, gt_active, matcher)
    queries = torch.arange(nq, device=owner.device)
    claimed = (owner[:, :, None] == queries[None, None]) & gt_active[:, :, None]
    matched = torch.any(claimed, dim=1)
    first_m = torch.argmax(claimed.to(torch.int32), dim=1)
    cls_of = torch.gather(gt_cls.long(), 1, first_m)
    tgt_cls = torch.where(matched, cls_of, cfg.n_classes)
    cls_loss = det._class_loss(cls_logits, tgt_cls, cfg.n_classes)
    matched_box = torch.gather(boxes, 1,
                               owner.long()[..., None].expand(-1, -1, 4))
    l1 = torch.sum(torch.abs(matched_box - gt_box), dim=-1)
    act = gt_active.to(torch.float32)
    box_loss = torch.sum(l1 * act) / torch.clamp(torch.sum(act), min=1.0)
    return cls_loss + box_loss, {"cls_loss": cls_loss, "box_loss": box_loss}


@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
def test_three_stage_decoder_loss_is_the_composition_it_replaced(matcher):
    cfg = _detector("decoder_hungarian")
    params = det.init_detector(cfg, torch.Generator().manual_seed(1), "cpu")
    img, _, _, gt = _detector_batch(cfg, 0)
    out = {}
    for label, fn in (("stages", det.decoder_detection_loss),
                      ("one", _composition_it_replaced)):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, live)
        loss, extras = fn(tree, cfg, img, gt["cls"], gt["box"], gt["active"],
                          matcher)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        out[label] = (loss, extras, grads)
    (l1, e1, g1), (l2, e2, g2) = out["stages"], out["one"]
    assert torch.equal(l1, l2)
    for k in ("cls_loss", "box_loss"):
        assert torch.equal(e1[k], e2[k])
    assert len(g1) == len(g2)
    for a, b in zip(g1, g2):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_loss_split_is_none_without_a_host_stage():
    """The split exists only for the decoder head under the Hungarian
    matcher; its stages compose to the loss bitwise."""
    api = detr.detector_api("cuda_decode")
    dec_cfg, dense = _detector("decoder_hungarian"), _detector("dense")
    batch = _detector_batch(dec_cfg, 0)
    assert api.loss_split(dense, _detector_batch(dense, 0)) is None
    with _matcher("decoder_greedy"):
        assert api.loss_split(dec_cfg, batch) is None
    split = api.loss_split(dec_cfg, batch)
    params = det.init_detector(dec_cfg, torch.Generator().manual_seed(1), "cpu")
    carry, cost = split.device(params, dec_cfg, batch)
    owner = torch.from_numpy(split.host(cost.numpy()))
    assert owner.dtype == torch.int32 and owner.shape == batch[3]["box"].shape[:2]
    loss, _ = split.finish(carry, owner, dec_cfg, batch)
    want, _ = api.loss_fn(params, dec_cfg, batch)
    assert torch.equal(loss, want)


# --------------------------------------------------------------------------
# the standing state
# --------------------------------------------------------------------------

def _functional_lm_step(cfg, state, batch):
    loss, metrics, grads = _loss_and_grads(cfg, _api(cfg))(state.params, batch)
    params, opt, om = adamw_update(state.params, grads, state.opt,
                                   OptConfig(**OPT_KW))
    return TrainState(params, opt, state.step + 1), dict(metrics, loss=loss, **om)


def _api(cfg):
    from repro_torch.models.registry import get_api
    return get_api(cfg)


@pytest.mark.parametrize("case", ["lm_accum1", "lm_accum2", *DETECTORS])
def test_step_keeps_addresses_and_is_the_functional_step(case):
    """Over 3 steps every leaf of the returned state (params, m, v, both
    step counts) stays at the address of the first, and its values and
    the metrics are bitwise the functional step's."""
    if case.startswith("lm"):
        cfg = dataclasses.replace(LM_CFG, grad_accum=int(case[-1]))
        step = build_train_step(cfg, OptConfig(**OPT_KW))
        state = ref = _lm_state(cfg)
        batches = [_lm_batch(i, cfg) for i in range(3)]

        def functional(st, batch):
            return _functional_lm_step(cfg, st, batch)
        matcher = contextlib.nullcontext()
    else:
        cfg = _detector(case)
        api = detr.detector_api("cuda_decode")
        opt_cfg = OptConfig(**TOY_OPT_KW)
        step = build_train_step(cfg, opt_cfg, api)
        state = ref = make_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu", api=api)
        batches = [_detector_batch(cfg, i) for i in range(3)]

        def functional(st, batch):
            p, o, m, _ = detr.train_step(st.params, st.opt, batch, cfg,
                                         opt_cfg, backend="cuda_decode")
            return TrainState(p, o, st.step + 1), m
        matcher = _matcher(case)
    initial = [t.clone() for t in _leaves(state)]
    addresses = None
    with matcher:
        for batch in batches:
            state, metrics = step(state, batch)
            ref, want = functional(ref, batch)
            where = [t.data_ptr() for t in _leaves(state)]
            addresses = addresses or where
            assert where == addresses
            assert set(metrics) == set(want)
            for k in want:
                assert torch.equal(metrics[k], want[k]), k
            _assert_bitwise(tuple(state), tuple(ref))
    assert int(state.step) == int(state.opt["step"]) == 3
    assert state is step.state
    # the caller's first state is untouched: the step copied it
    first = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu", api=None if case.startswith("lm")
                             else detr.detector_api("cuda_decode"))
    _assert_bitwise(tuple(first), initial)


def test_fresh_state_lands_in_the_standing_state():
    """A restart in the same process hands the step a fresh state: it is
    copied into the standing state, whose addresses the graphs read, and
    the step goes on bitwise as a step that started from it."""
    opt = OptConfig(**OPT_KW)
    step = build_train_step(LM_CFG, opt)
    state, _ = step(_lm_state(), _lm_batch(0))
    where = [t.data_ptr() for t in _leaves(state)]
    fresh = make_train_state(LM_CFG, torch.Generator().manual_seed(5),
                             device="cpu")
    kept = [t.clone() for t in _leaves(fresh)]
    again, m = step(fresh, _lm_batch(1))
    assert again is state and [t.data_ptr() for t in _leaves(again)] == where
    _assert_bitwise(tuple(fresh), kept)           # the caller's copy
    other, m_other = build_train_step(LM_CFG, opt)(fresh, _lm_batch(1))
    _assert_bitwise(tuple(again), tuple(other))
    assert torch.equal(m["loss"], m_other["loss"])
    with pytest.raises(ValueError, match="structure"):
        step(_lm_state(dataclasses.replace(LM_CFG, d_ff=88)), _lm_batch(2))


def test_restore_into_writes_in_place_bitwise(tmp_path):
    """``in_place=True`` writes every saved leaf into the template's own
    tensor (float32, bf16, int32), bitwise; the default returns new
    tensors and leaves the template as it was."""
    g = torch.Generator().manual_seed(0)
    saved = TrainState({"w": torch.randn((6, 4), generator=g).to(torch.bfloat16),
                        "b": [torch.randn((5,), generator=g)]},
                       {"step": torch.full((), 7, dtype=torch.int32)},
                       torch.full((), 7, dtype=torch.int32))
    store.save_checkpoint(str(tmp_path), 7, saved)
    _, loaded = store.load_checkpoint(str(tmp_path))
    zeros = lambda: TrainState(*(  # noqa: E731
        {"w": torch.zeros((6, 4), dtype=torch.bfloat16),
         "b": [torch.zeros(5)]}, {"step": torch.zeros((), dtype=torch.int32)},
        torch.zeros((), dtype=torch.int32)))
    tmpl = zeros()
    back = store.restore_into(tmpl, loaded, in_place=True)
    assert isinstance(back, TrainState)
    for a, b in zip(_leaves(back), _leaves(tmpl)):
        assert a is b
    for a, b in zip(_leaves(back), _leaves(saved)):
        assert a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    tmpl = zeros()
    back = store.restore_into(tmpl, loaded)
    _assert_bitwise(tuple(back), tuple(saved))
    assert all(not bool(t.any()) for t in _leaves(tmpl))


def test_checkpoint_snapshot_is_taken_before_the_next_step(tmp_path):
    """AsyncCheckpointer.save copies the standing state to the host before
    it returns: the next step rewrites the state in place, the file holds
    the state as saved."""
    step = build_train_step(LM_CFG, OptConfig(**OPT_KW))
    state, _ = step(_lm_state(), _lm_batch(0))
    kept = [t.clone() for t in _leaves(state)]
    ck = store.AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(1, state)
    state, _ = step(state, _lm_batch(1))
    ck.close()
    _, loaded = store.load_checkpoint(str(tmp_path))
    _assert_bitwise(tuple(store.restore_into(_lm_state(), loaded)), kept)


# --------------------------------------------------------------------------
# bodies read nothing back
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _host_reads_raise():
    def refuse(name):
        def raise_(*_a, **_k):
            raise AssertionError(f"host read Tensor.{name} in a graph body")
        return raise_
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    try:
        for n in HOST_READS:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.fixture
def bodies_refuse_host_reads(monkeypatch):
    """Every body the graph set runs runs with the host reads refused;
    the host stages run between them as they do on the card."""
    real_call = CapturedGraphs._call
    hosts = []

    def call(self, body):
        with _host_reads_raise():
            return real_call(self, body)
    real_host = CapturedGraphs._host

    def host(self, fn, carry):
        hosts.append(1)
        return real_host(self, fn, carry)
    monkeypatch.setattr(CapturedGraphs, "_call", call)
    monkeypatch.setattr(CapturedGraphs, "_host", host)
    return hosts


LM_ARCHS = ("deepseek-7b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b",
            "llava-next-34b", "whisper-tiny")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_bodies_read_nothing_back(bodies_refuse_host_reads, arch):
    """One SMOKE config per family the train launcher takes (dense, moe,
    ssm, hybrid, vlm, encdec), at accum 2: two steps run with the host
    reads refused inside the body."""
    cfg = dataclasses.replace(get_smoke_config(arch), grad_accum=2)
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=2, seed=1)
    step = build_train_step(cfg, OptConfig(**OPT_KW))
    state = _lm_state(cfg)
    for i in range(2):
        state, metrics = step(state, _lm_batch(i, cfg, data))
    assert np.isfinite(metrics["loss"].detach().numpy())
    assert bodies_refuse_host_reads == []


@pytest.mark.parametrize("case", sorted(DETECTORS))
def test_detector_bodies_read_nothing_back(bodies_refuse_host_reads, case):
    """The detector's bodies (forward, cost, losses, backward, AdamW) read
    nothing back; only the Hungarian matcher's host stage, run between
    its two bodies, reads the cost."""
    cfg = _detector(case)
    api = detr.detector_api("cuda_decode")
    step = build_train_step(cfg, OptConfig(**TOY_OPT_KW), api)
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu", api=api)
    with _matcher(case):
        for i in range(2):
            state, _ = step(state, _detector_batch(cfg, i))
    assert len(bodies_refuse_host_reads) == (2 if case == "decoder_hungarian"
                                             else 0)


def test_injected_host_read_in_a_body_raises(bodies_refuse_host_reads,
                                             monkeypatch):
    real = common.rms_norm

    def syncing(*args, **kwargs):
        out = real(*args, **kwargs)
        float(out.sum())                       # a device-to-host read
        return out
    monkeypatch.setattr(common, "rms_norm", syncing)
    from repro_torch.models import decoder, layers
    for mod in (decoder, layers):
        if hasattr(mod, "rms_norm"):
            monkeypatch.setattr(mod, "rms_norm", syncing)
    step = build_train_step(LM_CFG, OptConfig(**OPT_KW))
    with pytest.raises(AssertionError, match="host read"):
        step(_lm_state(), _lm_batch(0))


# --------------------------------------------------------------------------
# against the reference's jitted steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_lm_step_matches_the_reference_jitted_step(accum):
    rcfg = dataclasses.replace(r_smoke("deepseek-7b"), grad_accum=accum)
    cfg = dataclasses.replace(LM_CFG, grad_accum=accum)
    r_state = rstep.make_train_state(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, r_state.params),
                               device="cpu")
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32))
    r_step = jax.jit(rstep.build_train_step(rcfg, radamw.OptConfig(**OPT_KW)))
    step = build_train_step(cfg, OptConfig(**OPT_KW))
    data = rtokens.TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=2)
    for i in range(3):
        tokens = np.array(rtokens.synth_token_batch(data, i)["tokens"])
        r_state, r_m = r_step(r_state, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]), rtol=1e-5,
                                       err_msg=k)
    assert int(state.step) == int(r_state.step) == 3
    for got, want in ((state.params, r_state.params),
                      (state.opt["m"], r_state.opt["m"])):
        got, want = tree_leaves(got), jax.tree.leaves(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                       atol=5e-4)


def test_toy_decoder_step_matches_the_reference_jitted_step():
    """benchmarks/detr_toy.py's decoder ``step_fn`` (value_and_grad of
    ``decoder_detection_loss`` with the Hungarian matcher, then AdamW at
    the toy recipe, under ``jax.jit``) against the detector's captured
    step from the same weights, on the same 3 batches."""
    ref_cfg, cfg = tcases._cfgs("plain", True, "torch_gather")
    r_opt = radamw.OptConfig(**TOY_OPT_KW)

    @jax.jit
    def step_fn(params, opt, img, gc, gb, ga):
        (loss, _), grads = jax.value_and_grad(
            rdet.decoder_detection_loss, has_aux=True)(params, ref_cfg, img,
                                                      gc, gb, ga)
        params, opt, _ = radamw.adamw_update(params, grads, opt, r_opt)
        return params, opt, loss

    key = jax.random.PRNGKey(0)
    r_params = rdet.init_detector(key, ref_cfg)
    r_opt_state = radamw.adamw_init(r_params)
    api = detr.detector_api("cuda_decode")
    params = params_from_numpy(jax.tree.map(np.asarray, r_params), device="cpu")
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32))
    step = build_train_step(cfg, OptConfig(**TOY_OPT_KW), api)
    lrs = []
    for i in range(3):
        batch = jax.tree.map(np.asarray, rdata.synth_detection_batch(
            jax.random.fold_in(key, i), 2, ref_cfg.img_size,
            ref_cfg.level_shapes))
        img, _, _, gt = batch
        r_params, r_opt_state, r_loss = step_fn(
            r_params, r_opt_state, img, gt["cls"], gt["box"], gt["active"])
        state, m = step(state, tcases._port_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(r_loss), rtol=1e-5)
        lrs.append(float(m["lr"]))
    assert int(state.step) == int(r_opt_state["step"]) == 3
    bound = 2 * sum(lrs) * (1 + 1e-6)
    for a, b, rm, c in zip(tree_leaves(state.params),
                           jax.tree.leaves(r_params),
                           jax.tree.leaves(r_opt_state["m"]),
                           tree_leaves(state.opt["m"])):
        a, b, rm = a.numpy(), np.asarray(b), np.asarray(rm)
        roundoff = np.abs(rm) <= 1e-7
        np.testing.assert_allclose(a[~roundoff], b[~roundoff], rtol=5e-4,
                                   atol=5e-4)
        assert np.all(np.abs(a - b)[roundoff] <= bound)
        np.testing.assert_allclose(c.numpy(), rm, rtol=5e-4, atol=5e-4)
