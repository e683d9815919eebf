"""The LM substrate of the PyTorch port (dense family) against the JAX
reference: primitives, attention and MLP layers, the stacked decoder
(forward, prefill, decode_step), the token server and the ported configs
(all ten architectures; the other families' layers and models are
``test_torch_lm_families.py``'s).

Weights come over from the reference's param tree through
``bridge.params_from_numpy``; inputs are made with numpy from a seed.
On the CPU the port's decode attention runs K5's plain version.

Tolerances: float32 rtol = atol = 1e-5 (the same math, summed in
another order; the decode attention masks with -1e30 where the reference
masks with -1e9, which changes nothing while a row has a valid slot). bf16
cases are held to a few bf16 rounding steps, stated per test: XLA on the
CPU may keep bf16 intermediates in float32 where torch rounds each op.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import common as RC, decoder as RD  # noqa: E402
from repro.models import layers as RL, registry as RR  # noqa: E402
from repro.serve import lm as ref_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common as C, decoder as D  # noqa: E402
from repro_torch.models import layers as L, registry  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

torch.set_num_threads(1)

F32 = {"rtol": 1e-5, "atol": 1e-5}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _tree(ref_tree):
    return params_from_numpy(jax.tree.map(np.asarray, ref_tree), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def _tcfg(ref_cfg, **kw):
    """The port's ModelConfig with the reference config's fields."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    fields["dtype"] = DTYPES[jnp.dtype(ref_cfg.dtype).name][1]
    fields.update(kw)
    return C.ModelConfig(**fields)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_ported_config_fields_equal_the_reference(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for mine, ref in ((configs.get_config(arch), ref_configs.get_config(arch)),
                      (configs.get_smoke_config(arch),
                       ref_configs.get_smoke_config(arch))):
        for f in dataclasses.fields(ref):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            if f.name == "dtype":
                assert str(a).split(".")[-1] == jnp.dtype(b).name, arch
            else:
                assert a == b, (arch, f.name, a, b)
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(ref)]
        assert (mine.dh, mine.h_phys, mine.param_count()) == \
            (ref.dh, ref.h_phys, ref.param_count())
    if arch == "minitron-4b":
        assert configs.get_config(arch).param_count() == 4_190_306_304


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    """float32 to 1e-5 (rope at positions up to 4,000 radians); bf16 to
    rtol 2^-6 and atol 2^-6 — two bf16 rounding steps (both sides round
    cos, sin and each product; XLA may skip one of those roundings)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.asarray([0, 1, 17, 999, 3999], np.int32)
    tol = F32 if dtype == "float32" else {"rtol": 2 ** -6, "atol": 2 ** -6}
    xj, xt = jnp.asarray(x).astype(jdt), _t(x, tdt)
    _close(C.rms_norm(_t(scale, tdt), xt),
           RC.rms_norm(jnp.asarray(scale).astype(jdt), xj), **tol)
    _close(C.rope(xt, torch.from_numpy(pos)[None], 1e4),
           RC.rope(xj, jnp.asarray(pos)[None], 1e4), **tol)


def test_gelu_is_jax_default_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = C.gelu(_t(x))
    _close(got, jax.nn.gelu(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    assert float((got - torch.nn.functional.gelu(_t(x))).abs().max()) > 1e-4


def test_cross_entropy_loss():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 7, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 7)).astype(np.int32)
    mask = (rng.uniform(size=(2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = C.cross_entropy_loss(_t(logits), torch.from_numpy(labels),
                                   None if m is None else _t(m))
        want = RC.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        _close(got, want, **F32)


# --------------------------------------------------------------------------
# attention and MLP
# --------------------------------------------------------------------------

def _attn_cfgs(**kw):
    ref = RC.ModelConfig(d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                         vocab_size=64, dtype=jnp.float32, attn_chunk=4, **kw)
    return ref, _tcfg(ref)


@pytest.mark.parametrize("impl", ["dense", "blockwise"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pad_heads", [0, 6])
def test_attn_forward(impl, window, pad_heads):
    """S 12 at attn_chunk 4 takes the blockwise path (S > 2 chunks);
    ``pad_heads_to`` 6 adds two masked query heads."""
    rcfg, tcfg = _attn_cfgs(attn_impl=impl, pad_heads_to=pad_heads)
    p = RL.attn_init(jax.random.PRNGKey(0), rcfg)
    x = np.random.default_rng(2).normal(size=(2, 12, 32)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    want = RL.attn_forward(p, rcfg, jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(window, jnp.int32))
    got = L.attn_forward(_tree(p), tcfg, _t(x), torch.from_numpy(pos), window)
    _close(got, want, **F32)


@pytest.mark.parametrize("window", [0, 5])
def test_attn_prefill_then_decode_on_a_ring_buffer(window):
    """Prefill 6 tokens into an 8-slot ring buffer, then decode 6 steps at
    per-request positions (6, 8) -> (11, 13), wrapping the buffer (row
    1's slots for positions 6 and 7 stay empty until overwritten): every
    step's output and the final cache equal the reference's."""
    rcfg, tcfg = _attn_cfgs()
    p = RL.attn_init(jax.random.PRNGKey(1), rcfg)
    tp = _tree(p)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    win = jnp.asarray(window, jnp.int32)
    y_ref, rc = RL.attn_prefill(p, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                RL.attn_cache_init(rcfg, 2, 8), win)
    tc = L.attn_cache_init(tcfg, 2, 8, device="cpu")
    y, tc = L.attn_prefill(tp, tcfg, _t(x), torch.from_numpy(pos), tc, window)
    _close(y, y_ref, **F32)
    for step in range(6):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        pv = np.asarray([6 + step, 8 + step], np.int32)
        y_ref, rc = RL.attn_decode(p, rcfg, jnp.asarray(x1), rc,
                                   jnp.asarray(pv), win)
        y, tc = L.attn_decode(tp, tcfg, _t(x1), tc, torch.from_numpy(pv), window)
        _close(y, y_ref, **F32)
    for name in ("k", "v"):
        _close(tc[name], rc[name], **F32)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(rc["kpos"]))


def test_attn_decode_raises_where_k5_head_mapping_is_not_the_models():
    """K5 now takes the model's query-to-KV head map. With padded query
    heads (4 real over 2 KV heads, padded to 6: the padded heads clamp to
    the last KV head and are masked) attn_decode decodes through
    ops.flash_decode and equals the reference's attn_decode over three
    steps. With Hkv not dividing Hq and no padding (6 over 4) neither the
    reference nor the port can map the heads, and both raise."""
    kw = {"n_heads": 4, "n_kv_heads": 2, "pad_heads_to": 6}
    rcfg = RC.ModelConfig(d_model=48, d_ff=64, vocab_size=64,
                          dtype=jnp.float32, **kw)
    cfg = C.ModelConfig(d_model=48, d_ff=64, vocab_size=64,
                        dtype=torch.float32, **kw)
    p = RL.attn_init(jax.random.PRNGKey(5), rcfg)
    tp = _tree(p)
    rc, tc = RL.attn_cache_init(rcfg, 2, 8), L.attn_cache_init(cfg, 2, 8,
                                                               device="cpu")
    rng = np.random.default_rng(6)
    for step in range(3):
        x1 = rng.normal(size=(2, 1, 48)).astype(np.float32)
        pv = np.asarray([step, step + 2], np.int32)
        y_ref, rc = RL.attn_decode(p, rcfg, jnp.asarray(x1), rc,
                                   jnp.asarray(pv), jnp.asarray(0, jnp.int32))
        y, tc = L.attn_decode(tp, cfg, _t(x1), tc, torch.from_numpy(pv), 0)
        _close(y, y_ref, **F32)
    kw = {"n_heads": 6, "n_kv_heads": 4}
    rcfg = RC.ModelConfig(d_model=48, d_ff=64, vocab_size=64,
                          dtype=jnp.float32, **kw)
    cfg = C.ModelConfig(d_model=48, d_ff=64, vocab_size=64,
                        dtype=torch.float32, **kw)
    p = RL.attn_init(jax.random.PRNGKey(5), rcfg)
    with pytest.raises((ValueError, TypeError)):
        RL.attn_decode(p, rcfg, jnp.zeros((1, 1, 48)),
                       RL.attn_cache_init(rcfg, 1, 8),
                       jnp.zeros((1,), jnp.int32), jnp.asarray(0, jnp.int32))
    with pytest.raises(ValueError, match="GQA repeat needs Hkv"):
        L.attn_decode(_tree(p), cfg, torch.zeros((1, 1, 48)),
                      L.attn_cache_init(cfg, 1, 8, device="cpu"),
                      torch.zeros((1,), dtype=torch.int32), 0)


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_apply(gated):
    rcfg = RC.ModelConfig(d_model=32, d_ff=48, mlp_gated=gated,
                          dtype=jnp.float32)
    p = RL.mlp_init(jax.random.PRNGKey(4), rcfg)
    x = np.random.default_rng(4).normal(size=(2, 3, 32)).astype(np.float32)
    _close(L.mlp_apply(_tree(p), _t(x)), RL.mlp_apply(p, jnp.asarray(x)), **F32)


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------

def _decoder_pair(arch, dtype="float32"):
    rcfg = ref_configs.get_smoke_config(arch)
    if dtype != "float32":
        rcfg = dataclasses.replace(rcfg, dtype=DTYPES[dtype][0])
    p = RD.init_decoder(jax.random.PRNGKey(0), rcfg)
    return rcfg, _tcfg(rcfg), p, _tree(p)


def _run_decoder(rcfg, tcfg, p, tp, monkeypatch=None):
    """forward, prefill and 3 decode steps on both sides; returns
    [(port, reference)] outputs and the final caches."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab_size, (2, 9)).astype(np.int32)
    out = []
    lg, _ = D.forward(tp, tcfg, torch.from_numpy(toks))
    rlg, _ = RD.forward(p, rcfg, tokens=jnp.asarray(toks))
    out.append((lg, rlg))
    tc = D.init_cache(tcfg, 2, 16, device="cpu")
    rc = RD.init_cache(rcfg, 2, 16)
    lg, tc = D.prefill(tp, tcfg, tc, torch.from_numpy(toks))
    rlg, rc = RD.prefill(p, rcfg, rc, tokens=jnp.asarray(toks))
    out.append((lg, rlg))
    for step in range(3):
        nxt = rng.integers(0, rcfg.vocab_size, (2,)).astype(np.int32)
        pos = np.asarray([9 + step, 9 + step], np.int32)
        lg, tc = D.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos))
        rlg, rc = RD.decode_step(p, rcfg, rc, jnp.asarray(nxt), jnp.asarray(pos))
        out.append((lg, rlg))
    return out, tc, rc


@pytest.mark.parametrize("arch", ["minitron-4b", "deepseek-7b"])
def test_decoder_matches_reference(arch, monkeypatch):
    """The SMOKE configs in float32: minitron-4b (2-matrix tanh-GELU MLP,
    GQA 6 over 2) and deepseek-7b (SwiGLU, MHA 8 over 8). forward,
    prefill and three decode steps to 1e-5, the caches too, and every
    decode layer's attention goes through ops.flash_decode."""
    rcfg, tcfg, p, tp = _decoder_pair(arch)
    calls = []
    real = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out, tc, rc = _run_decoder(rcfg, tcfg, p, tp)
    assert len(calls) == 3 * rcfg.n_layers
    for got, want in out:
        assert got.shape == want.shape
        _close(got, want, **F32)
    for name in ("k", "v"):
        _close(tc[name], rc[name], **F32)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(rc["kpos"]))
    toks = np.random.default_rng(6).integers(0, 512, (2, 8)).astype(np.int32)
    loss, _ = registry.get_api(tcfg).loss_fn(tp, tcfg,
                                             {"tokens": torch.from_numpy(toks)})
    rloss, _ = RR.get_api(rcfg).loss_fn(p, rcfg, {"tokens": jnp.asarray(toks)})
    _close(loss, rloss, **F32)


def test_decoder_bf16_matches_reference():
    """minitron-4b SMOKE in bf16: logits held to atol 0.1 and rtol 2^-4
    (logits are O(1); after two layers of bf16 roundings that XLA and
    torch place differently, and K5's float32 probabilities where the
    reference rounds them to bf16, a logit moves by a few bf16 steps of
    the residual stream), and the median error to 1e-2."""
    rcfg, tcfg, p, tp = _decoder_pair("minitron-4b", "bfloat16")
    out, _, _ = _run_decoder(rcfg, tcfg, p, tp)
    for got, want in out:
        assert got.dtype == (torch.bfloat16 if got.dim() == 3 else torch.float32)
        _close(got, want, rtol=2 ** -4, atol=0.1)
        assert float(np.median(np.abs(got.float().numpy() - _np(want)))) < 1e-2


def test_every_reference_family_has_an_api():
    """get_api and the family's init (init_decoder, or init_encdec for
    encdec) work for all six families on the CPU, with the reference's
    param tree layout; an unknown family still raises."""
    from repro_torch.models import encdec as E
    for family in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
        rcfg = RC.ModelConfig(family=family, n_layers=2, n_enc_layers=1,
                              d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
                              vocab_size=64, n_experts=4, n_experts_active=2,
                              ssm_state=8, ssm_head_dim=8, enc_seq_len=8,
                              n_img_tokens=4, dtype=jnp.float32)
        cfg = _tcfg(rcfg)
        init = E.init_encdec if family == "encdec" else D.init_decoder
        params = init(cfg, device="cpu")
        api = registry.get_api(cfg)
        assert api.init is init
        ref = jax.eval_shape(lambda k: RR.get_api(rcfg).init(k, rcfg),
                             jax.random.PRNGKey(0))
        assert [tuple(t.shape) for t in jax.tree.leaves(
            jax.tree.map(np.asarray, _torch_tree_as_numpy(params)))] == \
            [tuple(t.shape) for t in jax.tree.leaves(ref)]
    cfg = C.ModelConfig(family="rnn", dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown family"):
        registry.get_api(cfg)
    with pytest.raises(ValueError, match="no 'rnn' family"):
        D.init_decoder(cfg, device="cpu")


def _torch_tree_as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree_as_numpy(v) for k, v in tree.items()}
    return tree.float().numpy()


# --------------------------------------------------------------------------
# the token server
# --------------------------------------------------------------------------

def _requests(module, lengths=(5, 9, 4), new=(6, 4, 5)):
    rng = np.random.default_rng(7)
    return [module.Request(rid=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                           max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, new))]


def test_serve_engine_greedy_tokens_equal_the_reference():
    """3 requests over max_batch 2, so that a slot is reused: every
    request's greedy tokens equal the reference engine's."""
    rcfg, tcfg, p, tp = _decoder_pair("minitron-4b")
    ref = ref_lm.ServeEngine(rcfg, p, ref_lm.ServeConfig(max_batch=2,
                                                         cache_len=32))
    for r in _requests(ref_lm):
        ref.submit(r)
    want = {r.rid: r.output for r in ref.run_until_drained()}
    eng = lm.ServeEngine(tcfg, tp, lm.ServeConfig(max_batch=2, cache_len=32),
                         device="cpu")
    for r in _requests(lm):
        eng.submit(r)
    done = eng.run_until_drained()
    assert {r.rid: r.output for r in done} == want
    assert [len(want[i]) for i in range(3)] == [6, 4, 5]
    assert all(r.done for r in done)


def test_serve_engine_sampling_and_starvation():
    """Sampling draws from the engine's generator (Gumbel-max, like
    jax.random.categorical): at a temperature near 0 it is greedy, and two
    engines with one seed agree. A step limit with work left raises."""
    _, tcfg, _, tp = _decoder_pair("minitron-4b")
    outs = []
    for greedy, temp in ((True, 1.0), (False, 1e-6), (False, 1.0), (False, 1.0)):
        eng = lm.ServeEngine(tcfg, tp, lm.ServeConfig(
            max_batch=2, cache_len=32, greedy=greedy, temperature=temp),
            torch.Generator().manual_seed(3), device="cpu")
        for r in _requests(lm):
            eng.submit(r)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
    assert outs[0] == outs[1] and outs[2] == outs[3] and outs[2] != outs[0]
    eng = lm.ServeEngine(tcfg, tp, lm.ServeConfig(max_batch=1, cache_len=32),
                         device="cpu")
    for r in _requests(lm):
        eng.submit(r)
    from repro_torch.serve.postproc import StarvationError
    with pytest.raises(StarvationError):
        eng.run_until_drained(max_steps=3)
