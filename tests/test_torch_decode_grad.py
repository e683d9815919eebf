"""The backward of K2 (persistent-cache decode) against the JAX reference.

  * ``msgs_decode_backward_plain`` against ``jax.vjp`` of the reference's
    ``msgs_decode_ref`` — the reference's ``custom_vjp`` backward — over
    {float32, bf16, int8 + scale} x {dense, compact remap with the
    sentinel row hit} x head_pack {1, 4} x L {1, 3}, with points on
    integer coordinates, outside their level and with probability 0;
  * ``torch.autograd.gradcheck`` of ``MsgsDecode`` in float64 (points off
    integer coordinates, where the sampling is differentiable);
  * the 6-layer decoder's loss and parameter gradients through the port's
    ``cuda_decode`` plan on the CPU against the reference's
    ``pallas_decode`` (Pallas in interpret mode, its ``custom_vjp``).

Tolerances: float32 rtol 1e-5 (atol 1e-5 on the table gradient, 1e-6
elsewhere: sums of a few terms in another order); bf16 tables: the
reference scatters the table gradient in bf16 and the port accumulates
in float32 and rounds once, so rtol 2^-7 plus an atol of 2^-7 of the
largest entry (a sum of rounded terms can cancel); int8: d_scale and the
point gradients rtol 1e-5 (codes get no gradient on either side). The
decoder: the reference test's loss rtol 1e-4 / atol 1e-5 and gradients
rtol 1e-3 / atol 1e-4 (tests/test_msda_backends.py:334-372)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import msda as rmsda  # noqa: E402
from repro.core import msdeform_attn as rattn, nn as rnn  # noqa: E402
from repro.kernels.msgs_decode import msgs_decode_ref  # noqa: E402
from repro_torch import msda  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.msdeform_attn import MSDeformAttnConfig  # noqa: E402
from repro_torch.kernels import msgs_decode as md  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

torch.set_num_threads(1)

LEVELS = ((6, 7), (3, 4), (2, 2))
STARTS = (0, 42, 54)
N_PIX = 58
B, NQ, H, K, DH = 2, 5, 4, 6, 8
N_ROWS_COMPACT = 31
TABLES = ("float32", "bfloat16", "int8")


def _points(rng, n_layers, *, on_grid=True, off_grid=False):
    """x, y, start, wl, hl, probs (B, L, Nq, H, K) as numpy: random
    levels, coordinates up to 1.5 px past every edge; with ``on_grid`` a
    quarter of the coordinates are integers; with ``off_grid`` every
    coordinate keeps a fractional part in [0.1, 0.9]. One point in eight
    has probability 0 (PAP-pruned)."""
    shape = (B, n_layers, NQ, H, K)
    lvl = rng.integers(0, len(LEVELS), shape)
    wl = np.asarray([w for _, w in LEVELS], np.int32)[lvl]
    hl = np.asarray([h for h, _ in LEVELS], np.int32)[lvl]
    st = np.asarray(STARTS, np.int32)[lvl]
    x = rng.uniform(-1.5, 1.5, shape) + rng.uniform(0, 1, shape) * wl
    y = rng.uniform(-1.5, 1.5, shape) + rng.uniform(0, 1, shape) * hl
    if on_grid:
        x = np.where(rng.uniform(size=shape) < 0.25, np.floor(x), x)
        y = np.where(rng.uniform(size=shape) < 0.25, np.floor(y), y)
    if off_grid:
        x = np.floor(x) + rng.uniform(0.1, 0.9, shape)
        y = np.floor(y) + rng.uniform(0.1, 0.9, shape)
    p = rng.uniform(size=shape)
    p = np.where(rng.uniform(size=shape) < 0.125, 0.0, p / p.sum(-1, keepdims=True))
    f = lambda a: a.astype(np.float32)
    return f(x), f(y), st, wl, hl, f(p)


def _table(rng, table, compact, g):
    """Staged table (B, H/G, N_rows, G·Dh), remap and int8 scale (numpy);
    a compact table routes 40 % of the pixels to its zero sentinel row."""
    n_rows = N_ROWS_COMPACT if compact else N_PIX
    shape = (B, H // g, n_rows, g * DH)
    scale = remap = None
    if table == "int8":
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        scale = rng.uniform(0.002, 0.02, (B, H // g, g * DH)).astype(np.float32)
    else:
        vp = rng.normal(size=shape).astype(np.float32)
        if table == "bfloat16":            # values exact in bf16
            vp = np.array(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    if compact:
        vp[:, :, -1] = 0
        remap = rng.integers(0, n_rows - 1, (B, N_PIX))
        remap = np.where(rng.uniform(size=(B, N_PIX)) < 0.4, n_rows - 1,
                         remap).astype(np.int32)
    return vp, remap, scale


def _reference_vjp(vp, pts, remap, scale, g_out, g, table):
    x, y, st, wl, hl, p = (jnp.asarray(a) for a in pts)
    rm = None if remap is None else jnp.asarray(remap)
    if table == "int8":
        f = lambda x_, y_, p_, s_: msgs_decode_ref(
            jnp.asarray(vp), x_, y_, st, wl, hl, p_, rm, s_, head_pack=g, dh=DH)
        _, vjp = jax.vjp(f, x, y, p, jnp.asarray(scale))
        d_x, d_y, d_p, d_s = vjp(jnp.asarray(g_out))
        d_v = None
    else:
        v = jnp.asarray(vp, jnp.bfloat16 if table == "bfloat16" else jnp.float32)
        f = lambda v_, x_, y_, p_: msgs_decode_ref(
            v_, x_, y_, st, wl, hl, p_, rm, head_pack=g, dh=DH)
        _, vjp = jax.vjp(f, v, x, y, p)
        d_v, d_x, d_y, d_p = vjp(jnp.asarray(g_out))
        d_s = None
    as_np = lambda a: None if a is None else np.asarray(a.astype(jnp.float32))
    return [as_np(a) for a in (d_v, d_x, d_y, d_p, d_s)]


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("table", TABLES)
def test_backward_plain_matches_reference_vjp(table, compact, g, n_layers):
    rng = np.random.default_rng([TABLES.index(table), compact, g, n_layers])
    pts = _points(rng, n_layers)
    vp, remap, scale = _table(rng, table, compact, g)
    g_out = rng.normal(size=(B, n_layers, NQ, H, DH)).astype(np.float32)
    want = _reference_vjp(vp, pts, remap, scale, g_out, g, table)

    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    vt = t(vp).to(torch.bfloat16) if table == "bfloat16" else t(vp)
    got = md.msgs_decode_backward_plain(vt, *map(t, pts), t(g_out), t(remap),
                                        t(scale), head_pack=g, dh=DH)
    if table == "int8":
        assert got[0] is None
    else:
        assert got[0].dtype == vt.dtype and got[4] is None
    if compact and table != "int8":   # the sentinel row is hit and trains
        assert np.abs(want[0][:, :, -1]).sum() > 0
    for name, a, w in zip(("d_vp", "d_x", "d_y", "d_p", "d_scale"), got, want):
        if w is None:
            continue
        a = a.float().numpy()
        if table == "bfloat16" and name == "d_vp":
            tol = dict(rtol=2 ** -7, atol=2 ** -7 * float(np.abs(w).max()))
        else:
            tol = dict(rtol=1e-5, atol=1e-5 if name == "d_vp" else 1e-6)
        np.testing.assert_allclose(a, w, err_msg=name, **tol)


@pytest.mark.parametrize("table", ["float32", "int8"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_msgs_decode_gradcheck(table, compact):
    rng = np.random.default_rng(7)
    x, y, st, wl, hl, p = _points(rng, 2, on_grid=False, off_grid=True)
    vp, remap, scale = _table(rng, table, compact, 4)
    d = lambda a: torch.from_numpy(np.array(a, np.float64)).requires_grad_()
    i = lambda a: None if a is None else torch.from_numpy(np.array(a))
    geo = (i(st), i(wl), i(hl))
    if table == "int8":
        codes = i(vp)
        f = lambda x_, y_, p_, s_: md.MsgsDecode.apply(
            codes, x_, y_, *geo, p_, i(remap), s_, 4, DH)
        args = (d(x), d(y), d(p), d(scale))
    else:
        f = lambda v_, x_, y_, p_: md.MsgsDecode.apply(
            v_, x_, y_, *geo, p_, i(remap), None, 4, DH)
        args = (d(vp), d(x), d(y), d(p))
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-5)


def test_msgs_decode_output_carries_a_gradient():
    """The decode wrapper is an autograd op: under grad its output has a
    grad_fn and every float operand gets a gradient; under inference it
    computes the same values."""
    rng = np.random.default_rng(3)
    pts = [torch.from_numpy(np.array(a)) for a in _points(rng, 1)]
    v = torch.from_numpy(rng.normal(size=(B, N_PIX, H, DH)).astype(np.float32))
    v.requires_grad_()
    pts[0].requires_grad_()
    staged = md.stage_decode_table(v, head_pack=4)
    out = md.msgs_decode(staged, *(t[:, 0] for t in pts))
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert float(v.grad.abs().sum()) > 0 and float(pts[0].grad.abs().sum()) > 0
    with torch.inference_mode():
        again = md.msgs_decode(md.stage_decode_table(v.detach(), head_pack=4),
                               *(t.detach()[:, 0] for t in pts))
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)


def test_backward_wrapper_rejects_a_misshapen_gradient():
    rng = np.random.default_rng(4)
    pts = [torch.from_numpy(np.array(a)) for a in _points(rng, 2)]
    vp, _, _ = _table(rng, "float32", False, 1)
    staged = md.DecodeStagedTable(v=torch.from_numpy(vp), remap=None,
                                  n_rows=N_PIX, head_pack=1, dh=DH,
                                  table_bytes=0)
    with pytest.raises(ValueError, match="g_out must be"):
        md.msgs_decode_backward(staged, *pts, torch.zeros((B, 2, NQ, H, DH + 1)))
    got = md.msgs_decode_backward(staged, *pts, torch.ones((B, 2, NQ, H, DH)))
    assert got[0].shape == staged.v.shape and got[1].shape == pts[0].shape
    # a staged table that needs no gradient gets none
    x = pts[0].clone().requires_grad_()
    out = md.msgs_decode_layers(staged, x, *pts[1:])
    assert out.grad_fn.needs_input_grad[:2] == (False, True)
    out.sum().backward()
    assert staged.v.grad is None and x.grad.shape == x.shape


@pytest.mark.parametrize("source,entry", [
    ("msgs_decode.cu", "msgs_decode_forward"),
    ("msgs_decode_bwd.cu", "msgs_decode_backward"),
    ("msgs_decode_bwd.cu", "msgs_decode_backward_scratch")])
def test_ctypes_declarations_match_the_c_entries(source, entry):
    """ctypes checks only the argument count against ``argtypes``, not
    against the C function: each declared type must match the C
    signature's parameter, in order."""
    from pathlib import Path
    import re
    text = (Path(md.__file__).parents[1] / "csrc" / source).read_text()
    params = re.search(rf'extern "C" int {entry}\((.*?)\)', text, re.S).group(1)
    kinds = []
    for param in params.split(","):
        param = param.strip()
        kinds.append("ptr" if "*" in param else
                     "int64" if param.startswith("long long") else "int")
    want = {"c_void_p": "ptr", "c_longlong": "int64", "c_long": "int64",
            "c_int": "int"}
    assert [want[t.__name__] for t in md.ARGTYPES[entry]] == kinds


# --------------------------------------------------------------------------
# the 6-layer decoder: cuda_decode (port, CPU) vs pallas_decode (reference)
# --------------------------------------------------------------------------

D_LEVELS = ((16, 20), (8, 10), (4, 5), (2, 3))
D_N_IN = sum(h * w for h, w in D_LEVELS)
N_DEC_Q = 20
RANGES = (5.7, 3.9, 2.6, 1.7)      # clamped offsets land off the pixel grid


@functools.lru_cache(maxsize=None)
def _decoder_case():
    """Reference attention params (d_model 128, 4 heads: Dh 32, so the
    staging packs G = 4 heads), an FWP-compact link from one jnp_gather
    encoder block, random decoder params, and the reference's loss and
    gradients through ``pallas_decode``."""
    rng = np.random.default_rng(29)
    kw = dict(d_model=128, n_heads=4, range_narrow=RANGES, fwp_mode="compact",
              fwp_k=1.0, fwp_capacity=0.6)
    rcfg = rattn.MSDeformAttnConfig(**kw)
    params = jax.tree.map(np.asarray, rattn.init_msdeform_attn(
        jax.random.PRNGKey(31), rcfg))
    params["offs_w"] = (rng.normal(size=params["offs_w"].shape) * 0.1
                        ).astype(np.float32)
    q = rng.normal(size=(1, D_N_IN, 128)).astype(np.float32)
    x = rng.normal(size=(1, D_N_IN, 128)).astype(np.float32)
    refs = np.asarray(rnn.reference_points_for_levels(D_LEVELS))[None]
    dcfg = rmsda.MSDADecoderConfig(n_layers=6, n_queries=N_DEC_Q, d_ffn=64)
    dparams = jax.tree.map(np.asarray, rmsda.init_decoder(
        jax.random.PRNGKey(37), dcfg, rcfg))
    for layer in dparams["layers"]:          # live refinement heads
        layer["ref_delta"]["w"] = (rng.normal(size=layer["ref_delta"]["w"].shape)
                                   * 0.05).astype(np.float32)
    plan_e = rmsda.make_plan(rcfg, D_LEVELS, backend="jnp_gather")
    plan_d = rmsda.make_plan(rcfg, D_LEVELS, backend="pallas_decode",
                             n_queries=N_DEC_Q, n_consumers=6)

    @jax.jit
    def run(params, q, refs, x, dparams):
        _, state = rmsda.msda_attention(params, plan_e, q, refs, x)

        def loss(p):
            h, r, _ = rmsda.decoder_apply(p, dcfg, plan_d, x, state)
            return jnp.mean(jnp.square(h)) + jnp.mean(r)
        return state.fwp.keep_idx, jax.value_and_grad(loss)(dparams)
    keep, (val, grads) = run(params, q, refs, x, dparams)
    return (kw, params, q, refs, x, dparams, np.asarray(keep), float(val),
            jax.tree.map(np.asarray, grads))


def test_decoder_grads_cuda_decode_match_reference_pallas_decode():
    kw, params, q, refs, x, dparams, keep, r_val, r_grads = _decoder_case()
    cfg = MSDeformAttnConfig(**kw)
    t = lambda a: torch.from_numpy(np.array(a))
    p = params_from_numpy(params, device="cpu")
    _, state = msda.msda_attention(p, msda.make_plan(cfg, D_LEVELS,
                                                     backend="torch_gather"),
                                   t(q), t(refs), t(x))
    np.testing.assert_array_equal(state.fwp.keep_idx.numpy(), keep)

    dcfg = msda.MSDADecoderConfig(n_layers=6, n_queries=N_DEC_Q, d_ffn=64)
    plan = msda.make_plan(cfg, D_LEVELS, backend="cuda_decode",
                          n_queries=N_DEC_Q, n_consumers=6)
    assert plan.decode_head_pack == 4
    dp = params_from_numpy(dparams, device="cpu")
    leaves = tree_leaves(dp)
    for leaf in leaves:
        leaf.requires_grad_()
    h, r, dstate = msda.decoder_apply(dp, dcfg, plan, t(x), state)
    assert dstate.cache.staged is not None
    loss = h.square().mean() + r.mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), r_val, rtol=1e-4, atol=1e-5)
    r_leaves = jax.tree.leaves(r_grads)
    assert len(r_leaves) == len(grads)
    for gt_, gr in zip(grads, r_leaves):
        got = np.zeros_like(gr) if gt_ is None else gt_.numpy()
        np.testing.assert_allclose(got, gr, rtol=1e-3, atol=1e-4)
    # the shared value projection and every layer's sampling weights train
    g_of = dict(zip(map(id, leaves), grads))
    assert float(g_of[id(dp["value"]["value_w"])].abs().sum()) > 0
    for layer in dp["layers"]:
        assert float(g_of[id(layer["cross"]["offs_w"])].abs().sum()) > 0
