"""The port's MSDA layer against the JAX reference: a 2-block
``msda_attention`` chain over the matrix {fwp off/mask/compact} x
{pap off/threshold/topk} x {float32, int8 table}, through ``torch_gather``,
``cuda_fused`` and ``cuda_windowed`` (on CPU tensors: the kernels' plain
versions; the windows cover every corner the range bounds let a point
reach), and the decode-shaped ``cuda_decode`` path, all against
``jnp_gather``.

The FWP state (counts, keep mask, keep list, pix2slot) must be equal.
Block outputs: float32 tables rtol = atol = 1e-5. int8 tables: the two
sides project the values with different matmul orders, so a value within
an ulp of a rounding boundary may take the neighbouring code; one code
step of channel c moves a head's aggregate by at most its scale s_c (the
bilinear x probability weights of one (q, h) sum to at most 1), so the
bound is atol = max_b sum_{h,c} s_{b,h,c} |W_o[h,c,d]| + 1e-5.

The reference runs under ``jax.jit``. Its range bounds are kept off the
pixel grid: an offset clamped to an integer bound puts a sampling
coordinate exactly on a pixel edge, where XLA's fused multiply-add and
torch's separate multiply and add floor to different corners (the
bilinear value is continuous there, the FWP counts are not)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import msda as rmsda  # noqa: E402
from repro.core import msdeform_attn as rattn, nn as rnn  # noqa: E402
from repro_torch import msda  # noqa: E402
from repro_torch.core.msdeform_attn import MSDeformAttnConfig  # noqa: E402

torch.set_num_threads(1)

LEVELS = ((16, 20), (8, 10), (4, 5), (2, 3))
N_IN = sum(h * w for h, w in LEVELS)
RANGES = (5.7, 3.9, 2.6, 1.7)   # clamped offsets land off the pixel grid
FWP = ("off", "mask", "compact")
PAP = ("off", "threshold", "topk")
TABLES = ("float32", "int8")


@functools.lru_cache(maxsize=None)
def _inputs(d_model: int):
    """Reference params (random offset weights, so no sampling coordinate
    sits on an integer) and raster inputs, as numpy."""
    rng = np.random.default_rng(d_model)
    kw = dict(d_model=d_model, n_heads=4, range_narrow=RANGES, fwp_k=1.0,
              fwp_capacity=0.6, pap_keep=4, pap_threshold=0.05)
    params = jax.tree.map(np.asarray, rattn.init_msdeform_attn(
        jax.random.PRNGKey(d_model), rattn.MSDeformAttnConfig(**kw)))
    params["offs_w"] = (rng.normal(size=params["offs_w"].shape) * 0.1
                        ).astype(np.float32)
    b = 2
    q = rng.normal(size=(b, N_IN, d_model)).astype(np.float32)
    x = rng.normal(size=(b, N_IN, d_model)).astype(np.float32)
    refs = np.broadcast_to(np.asarray(rnn.reference_points_for_levels(LEVELS)),
                           (b, N_IN, 2)).copy()
    return kw, params, q, refs, x


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _cfgs(kw, fwp, pap, table):
    kw = dict(kw, fwp_mode=fwp, pap_mode=pap, table_dtype=table)
    return rattn.MSDeformAttnConfig(**kw), MSDeformAttnConfig(**kw)


@functools.lru_cache(maxsize=None)
def _ref_chains(table):
    """The reference's 2-block chain for every (fwp, pap) pair of one table
    dtype, compiled as ONE jitted function so XLA shares what the
    configurations have in common (each pair alone is its own compile)."""
    kw, params, q, refs, x = _inputs(64)
    plans = {(f, p): rmsda.make_plan(_cfgs(kw, f, p, table)[0], LEVELS,
                                     backend="jnp_gather")
             for f in FWP for p in PAP}

    @jax.jit
    def chains(params, q, refs, x):
        out = {}
        for key, plan in plans.items():
            out1, st1 = rmsda.msda_attention(params, plan, q, refs, x)
            out2, st2 = rmsda.msda_attention(params, plan, q, refs, x,
                                             state=st1)
            out[key] = (out1, st1.fwp, out2, st2.fwp)
        return out
    return chains(params, q, refs, x)


def _int8_bound(params_t, plan, x, state):
    cache = msda.build_value_cache(params_t, plan, x, state)
    s = cache.scale[:, 0]                                     # (B, H, Dh)
    w = params_t["out_w"].abs()                               # (H, Dh, D)
    return float(torch.einsum("bhc,hcd->bd", s, w).max()) + 1e-5


def _assert_fwp_equal(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    np.testing.assert_array_equal(got.keep_mask.numpy(),
                                  np.asarray(want.keep_mask))
    for name in ("keep_idx", "pix2slot"):
        w = getattr(want, name)
        g = getattr(got, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("backend",
                         ["torch_gather", "cuda_fused", "cuda_windowed"])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("pap", PAP)
@pytest.mark.parametrize("fwp", FWP)
def test_two_block_chain_matches_reference(fwp, pap, table, backend):
    kw, params, q, refs, x = _inputs(64)
    _, cfg = _cfgs(kw, fwp, pap, table)
    p = {k: _t(v) for k, v in params.items()}
    q, refs, x = _t(q), _t(refs), _t(x)
    plan = msda.make_plan(cfg, LEVELS, backend=backend)
    out1, st1 = msda.msda_attention(p, plan, q, refs, x)
    out2, st2 = msda.msda_attention(p, plan, q, refs, x, state=st1)
    r_out1, r_fwp1, r_out2, r_fwp2 = _ref_chains(table)[(fwp, pap)]
    _assert_fwp_equal(st1.fwp, r_fwp1)
    _assert_fwp_equal(st2.fwp, r_fwp2)
    for out, r_out, state in ((out1, r_out1, None), (out2, r_out2, st1)):
        atol = 1e-5 if table == "float32" \
            else _int8_bound(p, plan, x, state)
        np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=1e-5,
                                   atol=atol)


NQ_DEC = 30


@functools.lru_cache(maxsize=None)
def _decode_inputs():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(2, NQ_DEC, 128)).astype(np.float32),
            rng.uniform(0.05, 0.95, size=(2, NQ_DEC, 2)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _ref_decodes():
    """The reference's decode-shaped pass for every (fwp, table) pair, in
    one jitted function (see ``_ref_chains``)."""
    kw, params, q, refs, x = _inputs(128)
    qd, rd = _decode_inputs()
    plans = {}
    for f in FWP:
        for t in TABLES:
            rcfg = _cfgs(kw, f, "topk", t)[0]
            plans[(f, t)] = (
                rmsda.make_plan(rcfg, LEVELS, backend="jnp_gather"),
                rmsda.make_plan(rcfg, LEVELS, backend="jnp_gather",
                                n_queries=NQ_DEC, n_consumers=2))

    @jax.jit
    def decodes(params, q, refs, x, qd, rd):
        out = {}
        for key, (enc, dec) in plans.items():
            _, st = rmsda.msda_attention(params, enc, q, refs, x)
            cache = rmsda.build_value_cache(params, dec, x, st)
            out[key] = rmsda.msda_attention_cached(params, dec, qd, rd, cache,
                                                   update_fwp=False)[0]
        return out
    return decodes(params, q, refs, x, qd, rd)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("fwp", FWP)
def test_decode_shaped_cuda_decode_matches_reference(fwp, table):
    """Decode-shaped sampling (30 learned queries) of a cache built under
    the FWP link of one raster block, d_model 128 / 4 heads (Dh = 32, so
    the staging packs G = 4 heads per row as on the main path)."""
    kw, params, q, refs, x = _inputs(128)
    _, cfg = _cfgs(kw, fwp, "topk", table)
    qd, rd = _decode_inputs()
    want = _ref_decodes()[(fwp, table)]

    p = {k: _t(v) for k, v in params.items()}
    enc = msda.make_plan(cfg, LEVELS, backend="torch_gather")
    _, st = msda.msda_attention(p, enc, _t(q), _t(refs), _t(x))
    plan = msda.make_plan(cfg, LEVELS, backend="auto", n_queries=NQ_DEC,
                          n_consumers=2)
    assert plan.backend == "cuda_decode" and plan.decode_head_pack == 4
    cache = msda.build_value_cache(p, plan, _t(x), st)
    assert cache.staged is not None and cache.staged.head_pack == 4
    got, _ = msda.msda_attention_cached(p, plan, _t(qd), _t(rd), cache,
                                        update_fwp=False)
    atol = 1e-5 if table == "float32" else _int8_bound(p, plan, _t(x), st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


def test_plan_resolution_mirrors_reference_order(monkeypatch):
    kw, *_ = _inputs(64)
    cfg = MSDeformAttnConfig(**kw)
    assert msda.make_plan(cfg, LEVELS).backend == "torch_gather"   # impl="jnp"
    assert msda.make_plan(cfg, LEVELS, backend="auto").backend == "cuda_fused"
    assert msda.make_plan(cfg, LEVELS, backend="auto",
                          n_queries=30).backend == "cuda_decode"
    with pytest.raises(ValueError, match="decode-shaped"):
        msda.make_plan(cfg, LEVELS, backend="cuda_decode")
    with pytest.raises(ValueError, match="unknown MSDA backend"):
        msda.make_plan(cfg, LEVELS, backend="pallas_windowed")
    monkeypatch.setenv("REPRO_MSDA_TABLE_DTYPE", "int8")
    assert msda.plan_for(cfg, LEVELS).table_dtype == "int8"
    monkeypatch.setenv("REPRO_MSDA_QUERY_ORDER", "zorder")
    assert msda.make_plan(cfg, LEVELS).query_order == "zorder"
    monkeypatch.setenv("REPRO_MSDA_QUERY_ORDER", "hilbert")
    with pytest.raises(ValueError, match="query order"):
        msda.make_plan(cfg, LEVELS)
