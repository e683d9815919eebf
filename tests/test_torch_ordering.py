"""The port's cache-local query ordering (``repro_torch/msda/ordering.py``)
against the reference's ``repro/msda/ordering.py``.

Against the reference: sort keys, permutations, the dominant level and
the measured per-tile window bytes are EQUAL (integer results of the same
float32 products), and ``resolve_query_order`` has the same precedence
(argument > config field > ``REPRO_MSDA_QUERY_ORDER`` > ``"none"``) and
rejects the same names. The port's own property: ordering is a pure
permutation, so the MSDA output with ``raster`` / ``zorder`` equals the
unordered output BITWISE, through one decode-shaped block
(``torch_gather`` and ``cuda_decode``, whose plain version runs on CPU
tensors), through the 6-layer decoder, and on the raster-only
``cuda_windowed`` backend, which must not permute at all."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import msda as rmsda  # noqa: E402
from repro.core.msdeform_attn import MSDeformAttnConfig as RConfig  # noqa: E402
from repro.msda import ordering as rordering  # noqa: E402
from repro_torch import msda  # noqa: E402
from repro_torch.core import nn  # noqa: E402
from repro_torch.core.msdeform_attn import (MSDeformAttnConfig,  # noqa: E402
                                            init_msdeform_attn)
from repro_torch.msda import ordering  # noqa: E402

torch.set_num_threads(1)

LEVELS = ((16, 20), (8, 10), (4, 5), (2, 3))
N_IN = sum(h * w for h, w in LEVELS)
D = 64
N_DEC_Q = 40
RANGES = (6.0, 4.0, 3.0, 2.0)
METHODS = ("raster", "zorder")


def _refs(seed, shape):
    """Reference points in [0, 1), plus the exact edges 0 and 1 and points
    on the quantization grid of both key kinds."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    flat = r.reshape(-1, 2)
    edges = np.asarray([[0.0, 0.0], [1.0, 1.0], [0.5, 0.25],
                        [3 / 1024, 5 / 1024], [1 / 20, 1 / 16]], np.float32)
    flat[:len(edges)] = edges[:len(flat)]
    return r


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 300, 2), (1, 7, 2), (3, 1, 2)])
@pytest.mark.parametrize("method", METHODS)
def test_keys_and_permutations_equal_the_reference(method, shape):
    refs = _refs(sum(shape), shape)
    want_keys = np.asarray(rordering.query_sort_keys(jnp.asarray(refs), LEVELS,
                                                     method))
    keys = ordering.query_sort_keys(torch.from_numpy(refs), LEVELS, method)
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    want_perm, want_inv = rordering.query_permutation(jnp.asarray(refs),
                                                      LEVELS, method)
    perm, inv = ordering.query_permutation(torch.from_numpy(refs), LEVELS,
                                           method)
    assert perm.dtype == inv.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(want_inv))
    # a true permutation that inv undoes, with keys non-decreasing along it
    arr = torch.from_numpy(
        np.random.default_rng(5).normal(size=shape[:2] + (3, 5))
        .astype(np.float32))
    back = ordering.invert_queries(ordering.permute_queries(arr, perm), inv)
    assert torch.equal(back, arr)
    sorted_keys = ordering.permute_queries(keys, perm)
    assert bool((sorted_keys[:, 1:] >= sorted_keys[:, :-1]).all())
    np.testing.assert_array_equal(
        ordering.permute_queries(arr, perm).numpy(),
        np.asarray(rordering.permute_queries(jnp.asarray(arr.numpy()),
                                             want_perm)))


def test_dominant_level_and_raster_keys_follow_the_reference():
    assert ordering.dominant_level(LEVELS) == rordering.dominant_level(LEVELS)
    assert ordering.dominant_level(((2, 3), (9, 9), (8, 10))) == \
        rordering.dominant_level(((2, 3), (9, 9), (8, 10)))
    h, w = LEVELS[ordering.dominant_level(LEVELS)]
    refs = torch.tensor([[[0.5 / w, 0.5 / h], [1.5 / w, 0.5 / h],
                          [0.5 / w, 1.5 / h]]])
    keys = ordering.query_sort_keys(refs, LEVELS, "raster")[0]
    assert keys[0] < keys[1] < keys[2] and int(keys[2] - keys[0]) == w


@pytest.mark.parametrize("capacity", [None, 0.6])
@pytest.mark.parametrize("order", ("none",) + METHODS)
def test_tile_window_stats_equal_the_reference(order, capacity):
    refs = _refs(9, (1, N_DEC_Q, 2))
    kw = dict(tile_q=16, lanes=D, itemsize=4, order=order, capacity=capacity)
    assert ordering.tile_window_stats(refs, LEVELS, RANGES, **kw) == \
        rordering.tile_window_stats(refs, LEVELS, RANGES, **kw)


def test_resolve_query_order_precedence_matches_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_MSDA_QUERY_ORDER", raising=False)
    cfg, rcfg = MSDeformAttnConfig(d_model=D, n_heads=2), \
        RConfig(d_model=D, n_heads=2)
    both = lambda c, rc, arg=None: (ordering.resolve_query_order(c, arg),
                                    rordering.resolve_query_order(rc, arg))
    assert both(cfg, rcfg) == ("none", "none")
    monkeypatch.setenv("REPRO_MSDA_QUERY_ORDER", "zorder")
    assert both(cfg, rcfg) == ("zorder", "zorder")
    cfg_r = dataclasses.replace(cfg, query_order="raster")
    rcfg_r = dataclasses.replace(rcfg, query_order="raster")
    assert both(cfg_r, rcfg_r) == ("raster", "raster")
    assert both(cfg_r, rcfg_r, "none") == ("none", "none")
    # the plan takes the resolved order up, as the reference's does
    plan = msda.make_plan(cfg, LEVELS)
    assert plan.query_order == "zorder" and "order=zorder" in plan.describe()
    assert rmsda.make_plan(rcfg, LEVELS, backend="jnp_gather").query_order \
        == "zorder"
    assert msda.plan.resolve_query_order is ordering.resolve_query_order
    for bad in ("hilbert", "Z"):
        with pytest.raises(ValueError):
            ordering.resolve_query_order(cfg, bad)
        with pytest.raises(ValueError):
            rordering.resolve_query_order(rcfg, bad)
    with pytest.raises(ValueError):
        ordering.query_sort_keys(torch.zeros((1, 4, 2)), LEVELS, "hilbert")


# --------------------------------------------------------------------------
# the port's own property: ordering leaves outputs bitwise unchanged
# --------------------------------------------------------------------------

def _setup(fwp):
    kw = dict(d_model=D, n_heads=2, range_narrow=RANGES)
    if fwp != "off":
        kw.update(fwp_mode=fwp, fwp_k=1.0, fwp_capacity=0.6)
    cfg = MSDeformAttnConfig(**kw)
    gen = torch.Generator().manual_seed(3)
    params = init_msdeform_attn(cfg, gen, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, N_IN, D)).astype(np.float32))
    dq = torch.from_numpy(rng.normal(size=(2, N_DEC_Q, D)).astype(np.float32))
    drefs = torch.from_numpy(rng.uniform(0.05, 0.95, (2, N_DEC_Q, 2))
                             .astype(np.float32))
    state = None
    if fwp != "off":
        # an encoder block's FWP link, so the decode pass samples a
        # compacted table through pix2slot
        q = torch.from_numpy(rng.normal(size=(2, N_IN, D)).astype(np.float32))
        refs = nn.reference_points_for_levels(LEVELS)[None].expand(2, -1, -1)
        plan = msda.make_plan(cfg, LEVELS, backend="torch_gather")
        _, state = msda.msda_attention(params, plan, q, refs.contiguous(), x)
    return cfg, params, x, dq, drefs, state


@pytest.mark.parametrize("order", METHODS)
@pytest.mark.parametrize("fwp", ("off", "compact"))
@pytest.mark.parametrize("backend", ("torch_gather", "cuda_decode"))
def test_ordering_is_bitwise_identical_through_one_block(backend, fwp, order):
    cfg, params, x, dq, drefs, state = _setup(fwp)
    outs = {}
    for qorder in ("none", order):
        plan = msda.make_plan(cfg, LEVELS, backend=backend, n_queries=N_DEC_Q,
                              n_consumers=6, query_order=qorder)
        assert plan.query_order == qorder
        out, _ = msda.msda_attention(params, plan, dq, drefs, x, state=state)
        outs[qorder] = out
    assert torch.equal(outs[order], outs["none"])


@pytest.mark.parametrize("order", METHODS)
@pytest.mark.parametrize("backend", ("torch_gather", "cuda_decode"))
def test_ordering_is_bitwise_identical_through_the_decoder(backend, order):
    """Six layers, each deriving its permutation from its own incoming
    (pre-refinement) reference points."""
    cfg, _, x, _, _, state = _setup("compact")
    dcfg = msda.MSDADecoderConfig(n_layers=6, n_queries=N_DEC_Q, d_ffn=64)
    dparams = msda.init_decoder(dcfg, cfg, torch.Generator().manual_seed(41),
                                device="cpu")
    outs = {}
    for qorder in ("none", order):
        plan = msda.make_plan(cfg, LEVELS, backend=backend,
                              n_queries=dcfg.n_queries,
                              n_consumers=dcfg.n_layers, query_order=qorder)
        h, refs_out, _ = msda.decoder_apply(dparams, dcfg, plan, x, state)
        outs[qorder] = (h, refs_out)
    assert torch.equal(outs[order][0], outs["none"][0])
    assert torch.equal(outs[order][1], outs["none"][1])


def test_windowed_backend_keeps_queries_unpermuted(monkeypatch):
    """``cuda_windowed`` is raster-only: with an order requested the plan
    keeps the policy but the pass must not permute (the kernel derives
    its tile windows from raster query position)."""
    cfg, params, x, _, _, _ = _setup("off")
    assert msda.backend_info("cuda_windowed").raster_only
    calls = []
    real = ordering.query_permutation
    monkeypatch.setattr(ordering, "query_permutation",
                        lambda *a: calls.append(a) or real(*a))
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.normal(size=(2, N_IN, D)).astype(np.float32))
    refs = nn.reference_points_for_levels(LEVELS)[None].expand(2, -1, -1) \
        .contiguous()
    outs = {}
    for qorder in ("none", "zorder"):
        plan = msda.make_plan(cfg, LEVELS, backend="cuda_windowed",
                              query_order=qorder)
        assert plan.query_order == qorder
        outs[qorder], _ = msda.msda_attention(params, plan, q, refs, x)
    assert calls == []
    assert torch.equal(outs["zorder"], outs["none"])
    # a permuting backend does call it
    plan = msda.make_plan(cfg, LEVELS, backend="torch_gather",
                          query_order="zorder")
    msda.msda_attention(params, plan, q, refs, x)
    assert len(calls) == 1
