"""Activation checkpointing of the port's LM training forward
(``cfg.remat`` / ``cfg.remat_policy``, ``models/decoder.py`` and
``models/encdec.py``), against itself and against the reference.

  * remat off, ``"nothing"`` and ``"save_comm"`` give bitwise-equal loss
    and gradients on the CPU (a recomputed region runs the same
    operations on the same inputs);
  * the bytes saved for backward (``torch.autograd.graph.
    saved_tensors_hooks`` over the forward) order as off > save_comm >
    nothing where a layer has two sublayers (dense, MoE, hybrid), and
    save_comm = nothing where it has one (SSM);
  * with remat on, the port's gradients match the reference's
    ``jax.value_and_grad`` under the same policy to the LM family
    tests' tolerances (loss 1e-5, gradients rtol 1e-4 / atol 1e-5), for
    the decoder stack and the encoder-decoder;
  * under ``no_grad`` (serving) nothing is checkpointed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_torch_lm_families as LF  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro_torch.models import decoder as D  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

POLICIES = {"off": dict(remat=False),
            "nothing": dict(remat=True, remat_policy="nothing"),
            "save_comm": dict(remat=True, remat_policy="save_comm")}


def _case(family, seed=6):
    rcfg = LF.CFGS[family]
    p, tp = LF._model(rcfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, LF.V, (LF.B, LF.S + 1)).astype(np.int32)
    extras = LF._extras(rcfg, rng)
    return rcfg, p, tp, toks, extras


def _port_run(rcfg, tp, toks, extras, **kw):
    """(loss, gradient leaves, bytes saved for backward) of the port."""
    tcfg = LF._tcfg(rcfg, **kw)
    _, tb = LF._batches(rcfg, tcfg, toks, extras)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (loss, _), grads = value_and_grad(registry.get_api(tcfg).loss_fn, tp,
                                          tcfg, tb)
    return loss, tree_leaves(grads), saved[0]


@pytest.mark.parametrize("family", list(LF.CFGS))
def test_remat_policies_give_bitwise_loss_and_grads(family):
    rcfg, _, tp, toks, extras = _case(family)
    runs = {k: _port_run(rcfg, tp, toks, extras, **kw)
            for k, kw in POLICIES.items()}
    loss, grads, _ = runs["off"]
    assert torch.isfinite(loss)
    for name in ("nothing", "save_comm"):
        got_loss, got_grads, _ = runs[name]
        assert torch.equal(got_loss, loss), name
        assert len(got_grads) == len(grads)
        for g, w in zip(got_grads, grads):
            assert torch.equal(g, w), name
    saved = {k: v[2] for k, v in runs.items()}
    if family in ("ssm", "encdec"):       # one region per layer either way
        assert saved["off"] > saved["save_comm"] == saved["nothing"], saved
    else:
        assert saved["off"] > saved["save_comm"] > saved["nothing"], saved


@pytest.mark.parametrize("policy", ["nothing", "save_comm"])
@pytest.mark.parametrize("family", ["dense", "moe", "encdec"])
def test_remat_grads_match_reference(family, policy):
    rcfg, p, tp, toks, extras = _case(family)
    rcfg = dataclasses.replace(rcfg, remat=True, remat_policy=policy)
    rb, _ = LF._batches(rcfg, LF._tcfg(rcfg), toks, extras)
    (rloss, _), rgrads = jax.jit(
        jax.value_and_grad(RR.get_api(rcfg).loss_fn, has_aux=True),
        static_argnums=(1,), compiler_options=LF.FAST_COMPILE)(p, rcfg, rb)
    loss, grads, _ = _port_run(rcfg, tp, toks, extras)
    LF._close(loss, rloss, **LF.F32)
    want = jax.tree.leaves(rgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        LF._close(g, w, **LF.GRAD)


def test_no_checkpoint_without_grad(monkeypatch):
    """Serving runs no checkpointed region, whatever the config says."""
    calls = []
    monkeypatch.setattr(D, "checkpoint",
                        lambda *a, **k: calls.append(1) or a[0](*a[1:]))
    rcfg, _, tp, toks, _ = _case("dense")
    tcfg = LF._tcfg(rcfg, remat=True, remat_policy="save_comm")
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        D.forward(tp, tcfg, tokens=tokens)
    assert calls == []
    with torch.enable_grad():
        D.forward(tp, tcfg, tokens=tokens)
    assert len(calls) == 2 * tcfg.n_layers
