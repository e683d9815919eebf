"""Every LM family of the PyTorch port against the JAX reference: the MoE
layer, the Mamba2 SSD mixer, the hybrid, the vision-language path and
the encoder-decoder, besides dense; the six architectures they add; the
token server and the launchers over them.

Weights come over from the reference's param tree through
``bridge.params_from_numpy``; inputs are made with numpy from a seed. On
the CPU the decode attention runs K5's plain version.

Tolerances: float32 outputs, caches and losses rtol = atol = 1e-5 (the
same math summed in other orders; the SSD mixer's three-operand einsums
are two contractions each here); gradients rtol 1e-4, atol 1e-5 (a
backward pass sums over every token and layer). bf16: rtol 2^-4, atol
0.1 and a median error below 1e-2, as ``test_decoder_bf16_matches_reference``
in ``test_torch_lm.py`` holds the dense family.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import common as RC, decoder as RD, encdec as RE  # noqa: E402
from repro.models import layers as RL, registry as RR  # noqa: E402
from repro.serve import lm as ref_lm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common as C, decoder as D  # noqa: E402
from repro_torch.models import encdec as E, layers as L, registry  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serve import lm  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

torch.set_num_threads(1)

F32 = {"rtol": 1e-5, "atol": 1e-5}
GRAD = {"rtol": 1e-4, "atol": 1e-5}
BF16 = {"rtol": 2 ** -4, "atol": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, V = 2, 32, 256

# the reference's tests/test_models.py CFGS, by value
CFGS = {
    "dense": RC.ModelConfig(family="dense", n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab_size=V,
                            dtype=jnp.float32),
    "moe": RC.ModelConfig(family="moe", n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=96, vocab_size=V, n_experts=8,
                          n_experts_active=2, expert_capacity_factor=4.0,
                          dtype=jnp.float32),
    "ssm": RC.ModelConfig(family="ssm", n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=0, vocab_size=V, ssm_state=16,
                          ssm_head_dim=16, ssm_chunk=8, dtype=jnp.float32),
    "hybrid": RC.ModelConfig(family="hybrid", n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=2, d_ff=128, vocab_size=V, ssm_state=8,
                             ssm_head_dim=16, ssm_chunk=8, attn_window=8,
                             global_every=2, dtype=jnp.float32),
    "vlm": RC.ModelConfig(family="vlm", n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=2, d_ff=128, vocab_size=V, n_img_tokens=8,
                          dtype=jnp.float32),
    "encdec": RC.ModelConfig(family="encdec", n_layers=2, n_enc_layers=2,
                             d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                             vocab_size=V, enc_seq_len=16, dtype=jnp.float32),
}
NEW_ARCHS = ("olmoe-1b-7b", "grok-1-314b", "mamba2-130m", "hymba-1.5b",
             "whisper-tiny", "llava-next-34b")
#: one architecture per family, for the launchers
FAMILY_ARCH = {"dense": "minitron-4b", "moe": "olmoe-1b-7b",
               "ssm": "mamba2-130m", "hybrid": "hymba-1.5b",
               "vlm": "llava-next-34b", "encdec": "whisper-tiny"}
ATTN_FAMILIES = ("dense", "moe", "hybrid", "vlm", "encdec")


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _tree(ref_tree):
    return params_from_numpy(jax.tree.map(np.asarray, ref_tree), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def _bf16_close(got, want):
    _close(got, want, **BF16)
    assert float(np.median(np.abs(got.float().numpy() - _np(want)))) < 1e-2


def _tcfg(ref_cfg, **kw):
    """The port's ModelConfig with the reference config's fields."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    fields["dtype"] = DTYPES[jnp.dtype(ref_cfg.dtype).name][1]
    fields.update(kw)
    return C.ModelConfig(**fields)


#: XLA's LLVM backend at -O0: a third of the compile time on these toy
#: shapes; the HLO, and so the float semantics, are the same
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@functools.lru_cache(maxsize=None)
def _jit(fn, static=(1,)):
    """A reference function jitted with its config (argument 1) static:
    one XLA compile per function and shape instead of one per op."""
    return jax.jit(fn, static_argnums=static, compiler_options=FAST_COMPILE)


#: per-layer vectors of ones (norm scales, the SSD skip); the other
#: vectors (biases) are zeros, as the reference initialises them
_ONES = {"ln1", "ln2", "lnx", "norm", "norm_attn", "norm_ssm", "final_norm",
         "enc_norm", "d_skip"}


def _fan_in(name, inner):
    """The reference's ``init_dense`` scale dimension of a matrix."""
    if name in ("wq", "wk", "wv", "conv_w"):
        return inner[0]
    if name == "wo":
        return inner[0] * inner[1]
    if name == "embed":
        return inner[1]
    return inner[-2]


def _leaf(rng, name, shape, lead):
    """One weight as the reference's init draws it, with numpy's bits:
    ``lead`` leading dims are the layer stack."""
    inner = shape[lead:]
    if name == "a_log":
        return np.broadcast_to(np.log(np.linspace(1.0, 16.0, inner[0])), shape)
    if len(inner) == 1:
        return np.full(shape, 1.0 if name in _ONES else 0.0)
    return rng.standard_normal(shape) / np.sqrt(_fan_in(name, inner))


def _model(rcfg, seed=0):
    """The reference's param tree (structure and dtypes from its own init,
    traced only) filled with numpy draws from ``seed``, and the port's
    copy through params_from_numpy."""
    api = RR.get_api(rcfg)
    shapes = jax.eval_shape(lambda k: api.init(k, rcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    stacked = ("layers", "enc_layers", "dec_layers")

    def fill(path, sd):
        lead = 1 if path[0].key in stacked else 0
        a = _leaf(rng, path[-1].key, sd.shape, lead).astype(np.float32)
        return jnp.asarray(a).astype(sd.dtype)
    p = jax.tree_util.tree_map_with_path(fill, shapes)
    return p, _tree(p)


def _extras(rcfg, rng, b=B):
    """The stub frontends' inputs, numpy: image embeddings or frames."""
    if rcfg.family == "vlm":
        return {"img_embeds": rng.normal(size=(b, rcfg.n_img_tokens,
                                               rcfg.d_model)).astype(np.float32)}
    if rcfg.family == "encdec":
        return {"frames": rng.normal(size=(b, rcfg.enc_seq_len,
                                           rcfg.d_model)).astype(np.float32)}
    return {}


def _batches(rcfg, tcfg, tokens, extras):
    """The same batch for both packages (extras in the model dtype)."""
    rb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    for k, v in extras.items():
        rb[k] = jnp.asarray(v).astype(rcfg.dtype)
        tb[k] = _t(v, tcfg.dtype)
    return rb, tb


def _port_forward(params, cfg, batch):
    """(logits, aux) of the port's full-sequence forward."""
    if cfg.family == "encdec":
        return E.forward(params, cfg, batch["frames"], batch["tokens"])
    if cfg.family == "vlm":
        return D.forward(params, cfg,
                         embeds=registry._vlm_embeds(params, cfg, batch))
    return D.forward(params, cfg, tokens=batch["tokens"])


def _ref_run(params, cfg, batch, cache_len, steps):
    """The reference's forward (logits, aux), prefill of all but the last
    token into a fresh cache, and one decode step per (token, pos) of
    ``steps``: every output and the final cache, in one jit."""
    if cfg.family == "encdec":
        outs = [RE.forward(params, cfg, batch["frames"], batch["tokens"])]
    elif cfg.family == "vlm":
        outs = [RD.forward(params, cfg,
                           embeds=RR._vlm_embeds(params, cfg, batch))]
    else:
        outs = [RD.forward(params, cfg, tokens=batch["tokens"])]
    api = RR.get_api(cfg)
    cache = api.init_cache(cfg, batch["tokens"].shape[0], cache_len)
    logits, cache = api.prefill(params, cfg, cache,
                                dict(batch, tokens=batch["tokens"][:, :-1]))
    outs.append(logits)
    for tok, pos in steps:
        logits, cache = api.decode_step(params, cfg, cache, tok, pos)
        outs.append(logits)
    return outs, cache


def _run_family(rcfg, tcfg, p, tp, close, seed=5):
    """forward, prefill and three decode steps on both sides (the first
    decoded token the forward's last); checks every output and cache
    leaf with ``close`` (positions exactly) and the MoE aux."""
    rng = np.random.default_rng(seed)
    n_img = rcfg.n_img_tokens
    toks = rng.integers(0, rcfg.vocab_size, (B, S + 1)).astype(np.int32)
    rb, tb = _batches(rcfg, tcfg, toks, _extras(rcfg, rng))
    steps = [(toks[:, S] if i == 0 else
              rng.integers(0, rcfg.vocab_size, (B,)).astype(np.int32),
              np.full((B,), S + n_img + i, np.int32)) for i in range(3)]
    cache_len = S + n_img + 8
    (rfwd, *rlogits), rc = _jit(_ref_run, (1, 3))(
        p, rcfg, rb, cache_len, [tuple(map(jnp.asarray, st)) for st in steps])
    lg, aux = _port_forward(tp, tcfg, tb)
    assert lg.shape == rfwd[0].shape
    close(lg, rfwd[0])
    close(aux, rfwd[1])
    if rcfg.family == "moe":
        assert float(rfwd[1]) > 0
    api = registry.get_api(tcfg)
    tc = api.init_cache(tcfg, B, cache_len, device="cpu")
    lg, tc2 = api.prefill(tp, tcfg, tc, dict(tb, tokens=tb["tokens"][:, :S]))
    assert tc2 is tc
    outs = [lg]
    for tok, pos in steps:
        lg, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        outs.append(lg)
    for got, want in zip(outs, rlogits, strict=True):
        close(got, want)
    assert sorted(tc) == sorted(rc)
    for name in tc:
        if name == "kpos":
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(rc[name]))
        else:
            assert tc[name].dtype == DTYPES[jnp.dtype(rc[name].dtype).name][1]
            close(tc[name], rc[name])


# --------------------------------------------------------------------------
# every family at the reference's test sizes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(CFGS))
def test_family_forward_prefill_decode_match_reference(family):
    """The reference's CFGS in float32: forward logits and MoE aux, then
    prefill and three decode steps (the first token the forward's next),
    logits and every cache leaf, to 1e-5."""
    rcfg = CFGS[family]
    p, tp = _model(rcfg)
    _run_family(rcfg, _tcfg(rcfg), p, tp, lambda a, b: _close(a, b, **F32))


@pytest.mark.parametrize("family", list(CFGS))
def test_family_loss_and_grads_match_reference(family):
    """loss_fn and the gradient of every leaf against jax.value_and_grad:
    loss and its metrics to 1e-5, gradients to rtol 1e-4 / atol 1e-5."""
    rcfg = CFGS[family]
    tcfg = _tcfg(rcfg)
    p, tp = _model(rcfg)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, V, (B, S + 1)).astype(np.int32)
    rb, tb = _batches(rcfg, tcfg, toks, _extras(rcfg, rng))
    (rloss, rmet), rgrads = jax.jit(
        jax.value_and_grad(RR.get_api(rcfg).loss_fn, has_aux=True),
        static_argnums=(1,), compiler_options=FAST_COMPILE)(p, rcfg, rb)
    (loss, met), grads = value_and_grad(registry.get_api(tcfg).loss_fn, tp,
                                        tcfg, tb)
    _close(loss, rloss, **F32)
    for k in ("ce", "moe_aux"):
        _close(met[k], rmet[k], **F32)
    got, want = tree_leaves(grads), jax.tree.leaves(rgrads)
    assert len(got) == len(want) == len(tree_leaves(tp))
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        _close(g, w, **GRAD)
    assert max(float(g.abs().max()) for g in got) > 0


def test_every_family_decodes_in_place():
    """decode_step writes every cache leaf it keeps in place: the returned
    tree is the given one, each leaf keeps its data_ptr, and the leaves a
    step writes (KV ring, positions, SSD states) change; the encoder
    memory's K and V stay as prefill left them."""
    for family, rcfg in CFGS.items():
        tcfg = _tcfg(rcfg)
        api = registry.get_api(tcfg)
        tp = api.init(tcfg, torch.Generator().manual_seed(1), device="cpu")
        rng = np.random.default_rng(8)
        toks = rng.integers(0, V, (B, 6)).astype(np.int32)
        _, tb = _batches(rcfg, tcfg, toks, _extras(rcfg, rng))
        cache = api.init_cache(tcfg, B, 16, device="cpu")
        _, cache = api.prefill(tp, tcfg, cache, tb)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        before = {k: v.clone() for k, v in cache.items()}
        pos = torch.full((B,), 6 + tcfg.n_img_tokens, dtype=torch.int32)
        _, out = api.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, 0]),
                                 pos)
        assert out is cache, family
        assert {k: v.data_ptr() for k, v in out.items()} == ptrs, family
        for k, v in out.items():
            assert torch.equal(v, before[k]) == (k in ("mem_k", "mem_v")), \
                (family, k)


@pytest.mark.parametrize("family", ATTN_FAMILIES + ("ssm",))
def test_decode_calls_k5_once_per_attention_layer(family, monkeypatch):
    """With ops.flash_decode counting: one K5 call per attention layer and
    decode step (the encoder-decoder's self-attention only; its
    cross-attention stays plain); the SSM family makes none."""
    rcfg = CFGS[family]
    tcfg = _tcfg(rcfg)
    api = registry.get_api(tcfg)
    tp = api.init(tcfg, torch.Generator().manual_seed(2), device="cpu")
    calls = []
    real = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, V, (B, 5)).astype(np.int32)
    _, tb = _batches(rcfg, tcfg, toks, _extras(rcfg, rng))
    cache = api.init_cache(tcfg, B, 16, device="cpu")
    api.prefill(tp, tcfg, cache, tb)
    assert calls == []
    for step in range(2):
        api.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, step]),
                        torch.full((B,), 5 + tcfg.n_img_tokens + step,
                                   dtype=torch.int32))
    assert len(calls) == (0 if family == "ssm" else 2 * tcfg.n_layers)


# --------------------------------------------------------------------------
# the six architectures the families add
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arch_smoke_matches_reference(arch, dtype):
    """Each new architecture's SMOKE config through forward, prefill and
    decode against the reference: float32 to 1e-5; bf16 to rtol 2^-4,
    atol 0.1 and a median error below 1e-2 (bf16 roundings that XLA and
    torch place differently, and K5's float32 probabilities where the
    reference rounds them to bf16; the float32 router sees the same bf16
    activations on both sides, and these inputs leave no top-k margin
    under 1e-3, see test_moe_bf16_routing_equal_where_decided)."""
    rcfg = ref_configs.get_smoke_config(arch)
    rcfg = dataclasses.replace(rcfg, dtype=DTYPES[dtype][0])
    p, tp = _model(rcfg)
    close = (lambda a, b: _close(a, b, **F32)) if dtype == "float32" \
        else _bf16_close
    _run_family(rcfg, _tcfg(rcfg), p, tp, close)


def test_bridge_keeps_float32_leaves_of_a_bf16_model():
    """params_from_numpy on bf16 trees: the router and the SSD's a_log,
    d_skip and dt_bias stay float32, the rest bf16, every value exact;
    the encoder-decoder's enc_layers, dec_layers and xattn come across
    with the reference's structure."""
    f32_leaves = {"router", "a_log", "d_skip", "dt_bias"}
    for arch in ("olmoe-1b-7b", "hymba-1.5b", "whisper-tiny"):
        rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                                   dtype=jnp.bfloat16)
        p, tp = _model(rcfg)
        paths = jax.tree_util.tree_leaves_with_path(p)
        assert len(paths) == len(tree_leaves(tp))
        seen = set()
        for path, ref_leaf in paths:
            leaf = tp
            for key in path:
                leaf = leaf[key.key]
            name = path[-1].key
            seen.add(name)
            want = torch.float32 if name in f32_leaves else torch.bfloat16
            assert leaf.dtype == want, (arch, path)
            assert jnp.dtype(ref_leaf.dtype).name == str(want)[6:]
            np.testing.assert_array_equal(leaf.float().numpy(), _np(ref_leaf))
        if arch == "whisper-tiny":
            assert {"enc_layers", "dec_layers"} <= set(tp)
            assert set(tp["dec_layers"]["xattn"]) == {"wq", "wk", "wv", "wo"}
        else:
            assert seen & f32_leaves


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_pair(cf=0.5, dtype="float32", zero_router=False):
    rcfg = RC.ModelConfig(family="moe", d_model=32, d_ff=64, n_experts=4,
                          n_experts_active=2, expert_capacity_factor=cf,
                          dtype=DTYPES[dtype][0])
    p = _jit(RL.moe_init)(jax.random.PRNGKey(0), rcfg)
    if zero_router:
        p["router"] = jnp.zeros_like(p["router"])
    x = np.random.default_rng(10).normal(size=(2, 16, 32)).astype(np.float32)
    return rcfg, _tcfg(rcfg), p, _tree(p), x


def _reference_dispatch(p, rcfg, x):
    """The reference's dispatch on its own routing, in jnp (the same ops
    as ``repro.models.layers.moe_apply``'s): (order, keep, top_e)."""
    b, s, _ = x.shape
    k = rcfg.n_experts_active
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      p["router"]), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(b, s * k)
    order = jnp.argsort(flat_e, axis=-1)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, se, side="left"))(sorted_e)
    keep = (jnp.arange(s * k)[None] - first) < RL.moe_capacity(rcfg, s)
    return order, keep, top_e


def _reference_drops(p, rcfg, x):
    """The set of dropped (row, token, j) assignments, and top_e."""
    order, keep, top_e = map(np.asarray, _jit(_reference_dispatch)(p, rcfg, x))
    k = rcfg.n_experts_active
    return {(r, int(a) // k, int(a) % k) for r in range(order.shape[0])
            for a, kept in zip(order[r], keep[r]) if not kept}, top_e


def _port_drops(tp, tcfg, xt):
    _, _, top_e = L.moe_route(tp, tcfg, xt)
    order, keep, _, _ = L.moe_dispatch(tcfg, top_e, xt.shape[1])
    k = tcfg.n_experts_active
    return {(r, int(a) // k, int(a) % k) for r in range(order.shape[0])
            for a, kept in zip(order[r].tolist(), keep[r].tolist())
            if not kept}, top_e.numpy()


def test_moe_capacity_drops_the_references_assignments():
    """Capacity factor 0.5 (the reference's test_moe_capacity_drops_counted
    config): outputs and aux to 1e-5, and the dropped assignments are the
    reference's, the last tokens of each full expert's run."""
    rcfg, tcfg, p, tp, x = _moe_pair()
    out, aux = L.moe_apply(tp, tcfg, _t(x))
    rout, raux = _jit(RL.moe_apply)(p, rcfg, jnp.asarray(x))
    _close(out, rout, **F32)
    _close(aux, raux, **F32)
    drops, top_e = _port_drops(tp, tcfg, _t(x))
    rdrops, rtop_e = _reference_drops(p, rcfg, jnp.asarray(x))
    np.testing.assert_array_equal(top_e, rtop_e)
    assert drops == rdrops and len(drops) > 0
    # cap 4 per (row, expert) of 32 assignments: a quarter or more drop
    assert len(drops) >= 2 * 32 // 4


def test_moe_ties_pick_lower_experts_like_lax_top_k():
    """A zero router makes every probability equal: each token picks
    experts 0 .. k-1, as lax.top_k does, and the outputs match."""
    rcfg, tcfg, p, tp, x = _moe_pair(cf=4.0, zero_router=True)
    _, _, top_e = L.moe_route(tp, tcfg, _t(x))
    assert (top_e == torch.arange(2)).all()
    _, rtop_e = _reference_drops(p, rcfg, jnp.asarray(x))
    np.testing.assert_array_equal(top_e.numpy(), rtop_e)
    out, aux = L.moe_apply(tp, tcfg, _t(x))
    rout, raux = _jit(RL.moe_apply)(p, rcfg, jnp.asarray(x))
    _close(out, rout, **F32)
    _close(aux, raux, **F32)


def test_moe_apply_is_bitwise_repeatable():
    """The combine has no atomics and sums each token's contributions in a
    fixed order: two runs agree bit for bit, in both dtypes."""
    for dtype in ("float32", "bfloat16"):
        _, tcfg, _, tp, x = _moe_pair(cf=1.0, dtype=dtype)
        xt = _t(x, tcfg.dtype)
        a, aux_a = L.moe_apply(tp, tcfg, xt)
        b, aux_b = L.moe_apply(tp, tcfg, xt)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_bf16_routing_equal_where_decided():
    """bf16: wherever the gap between the k-th and (k+1)-th probability
    exceeds 1e-3 the port routes as the reference does, and on those
    tokens the outputs agree to bf16's limits (rtol 2^-4, atol 2^-5 of
    the largest output)."""
    rcfg, tcfg, p, tp, x = _moe_pair(cf=4.0, dtype="bfloat16")
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = _t(x, torch.bfloat16)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", xj.astype(jnp.float32),
                                      p["router"]), axis=-1)
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    decided = srt[..., 1] - srt[..., 2] > 1e-3                       # (B, S)
    assert decided.mean() > 0.5
    _, rtop_e = _reference_drops(p, rcfg, xj)
    _, _, top_e = L.moe_route(tp, tcfg, xt)
    np.testing.assert_array_equal(top_e.numpy()[decided], rtop_e[decided])
    out, _ = L.moe_apply(tp, tcfg, xt)
    rout, _ = _jit(RL.moe_apply)(p, rcfg, xj)
    got, want = out.float().numpy()[decided], _np(rout)[decided]
    np.testing.assert_allclose(got, want, rtol=2 ** -4,
                               atol=2 ** -5 * np.abs(want).max())


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------

def _ssd_pair(chunk, seq=32, d=32):
    rcfg = RC.ModelConfig(family="ssm", d_model=d, ssm_state=8, ssm_head_dim=8,
                          ssm_chunk=chunk, dtype=jnp.float32)
    p = _jit(RL.ssd_init)(jax.random.PRNGKey(0), rcfg)
    x = np.random.default_rng(11).normal(size=(2, seq, d)).astype(np.float32)
    return rcfg, _tcfg(rcfg), p, _tree(p), x


def test_ssd_chunk_invariance_in_both_packages():
    """Chunks 4 and 16 give the same mixer output (1e-4, the reference's
    own test limit) in each package, and each matches the reference at
    its chunk to 1e-5."""
    outs = {}
    for chunk in (4, 16):
        rcfg, tcfg, p, tp, x = _ssd_pair(chunk)
        got = L.ssd_forward(tp, tcfg, _t(x))
        want = _jit(RL.ssd_forward)(p, rcfg, jnp.asarray(x))
        _close(got, want, **F32)
        outs[chunk] = (got, want)
    _close(outs[4][0], outs[16][1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(outs[4][1]), _np(outs[16][1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(outs[4][0].numpy(), outs[16][0].numpy(),
                               rtol=1e-4, atol=1e-4)


def _ssd_with_state(p, cfg, x):
    return RL.ssd_forward(p, cfg, x, return_state=True)


def test_ssd_states_after_prefill_and_decode_match_reference():
    """S = 13 at chunk 8 (not a multiple): the output, the ``ssm`` and
    ``conv`` states after prefill equal the reference's, and four decode
    steps continuing from them match, states included (1e-5)."""
    rcfg, tcfg, p, tp, x = _ssd_pair(8, seq=13)
    y, st = _jit(_ssd_with_state)(p, rcfg, jnp.asarray(x))
    cache = L.ssd_cache_init(tcfg, 2, device="cpu")
    got, out_cache = L.ssd_prefill(tp, tcfg, _t(x), cache)
    assert out_cache is cache
    _close(got, y, **F32)
    for name in ("ssm", "conv"):
        assert cache[name].shape == st[name].shape
        _close(cache[name], st[name], **F32)
    rng = np.random.default_rng(12)
    rc = st
    for _ in range(4):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        ry, rc = _jit(RL.ssd_decode)(p, rcfg, jnp.asarray(x1), rc)
        ty, _ = L.ssd_decode(tp, tcfg, _t(x1), cache)
        _close(ty, ry, **F32)
    for name in ("ssm", "conv"):
        _close(cache[name], rc[name], **F32)


# --------------------------------------------------------------------------
# the token server and the launchers
# --------------------------------------------------------------------------

def _requests(module, lengths=(5, 9, 5), new=(6, 4, 5)):
    """Two prompt lengths: the reference engine compiles one prefill per
    length."""
    rng = np.random.default_rng(7)
    return [module.Request(rid=i, prompt=rng.integers(0, V, n).astype(np.int32),
                           max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, new))]


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_serve_engine_greedy_tokens_equal_the_reference(family):
    """3 requests over max_batch 2, so that a slot is reused: every
    request's greedy tokens equal the reference engine's."""
    rcfg = CFGS[family]
    p, tp = _model(rcfg)
    ref = ref_lm.ServeEngine(rcfg, p, ref_lm.ServeConfig(max_batch=2,
                                                         cache_len=32))
    for r in _requests(ref_lm):
        ref.submit(r)
    want = {r.rid: r.output for r in ref.run_until_drained()}
    eng = lm.ServeEngine(_tcfg(rcfg), tp, lm.ServeConfig(max_batch=2,
                                                         cache_len=32),
                         device="cpu")
    for r in _requests(lm):
        eng.submit(r)
    done = eng.run_until_drained()
    assert {r.rid: r.output for r in done} == want
    assert [len(want[i]) for i in range(3)] == [6, 4, 5]


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_serve_engine_and_launcher_refuse_families_with_other_inputs(family):
    """vlm and encdec prefill needs image embeddings or frames: the engine
    refuses them at construction, the launcher before building one."""
    tcfg = _tcfg(CFGS[family])
    tp = registry.get_api(tcfg).init(tcfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    with pytest.raises(ValueError, match="get_api"):
        lm.ServeEngine(tcfg, tp, lm.ServeConfig(max_batch=2, cache_len=32),
                       device="cpu")
    with pytest.raises(SystemExit, match="decoder-only text families"):
        launch_serve.main(["--arch", FAMILY_ARCH[family], "--smoke",
                           "--device", "cpu"])


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_launchers_run_every_family(family, capsys, tmp_path):
    """launch.train for every family (vlm with image embeddings, encdec
    with frames, drawn per step) and launch.serve for the text-only ones,
    in process on the CPU at SMOKE size."""
    arch = FAMILY_ARCH[family]
    assert launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "3", "--batch", "2", "--seq", "8",
                              "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "[train] done: final loss" in out
    loss = float(out.split("final loss ")[1].split(",")[0])
    assert np.isfinite(loss) and loss > 0
    if family in lm.SERVED_FAMILIES:
        assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                  "--requests", "3", "--max-new", "4"]) == 0
        assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out

