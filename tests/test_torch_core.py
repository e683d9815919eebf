"""Core numerics of the PyTorch port against the JAX reference: nn
primitives, fake-quant, PAP top-k under ties, FWP state builds, and the
MSDeformAttn oracle (plus an independent ``F.grid_sample`` cross-check).

Inputs are made with numpy from a seed and fed to both sides. Tolerances:
float32 rtol = atol = 1e-5 where the two sides sum in another order;
exact equality for everything discrete (codes, indices, keep lists)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import fwp as rfwp, nn as rnn, pap as rpap, quant as rquant  # noqa: E402
from repro.core import msdeform_attn as rmsda  # noqa: E402
from repro.msda import sampling as rsampling  # noqa: E402
from repro_torch.core import fwp, nn, pap, quant  # noqa: E402
from repro_torch.core import msdeform_attn as msda  # noqa: E402
from repro_torch.msda import sampling  # noqa: E402

torch.set_num_threads(1)

LEVELS = ((16, 20), (8, 10), (4, 5), (2, 3))
N_IN = sum(h * w for h, w in LEVELS)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# nn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_padding(size, stride):
    """lax SAME: stride 2 on an even input pads (0, 1), on an odd one (1, 1)."""
    rng = np.random.default_rng(size * 3 + stride)
    x = rng.normal(size=(2, 3, size, size)).astype(np.float32)
    p = {"w": rng.normal(size=(5, 3, 3, 3)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    want = rnn.conv2d({k: jnp.asarray(v) for k, v in p.items()}, x, stride=stride)
    got = nn.conv2d({k: _t(v) for k, v in p.items()}, _t(x), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_linear_and_embeddings():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 64)) * 3 + 1).astype(np.float32)
    ln = {"scale": rng.normal(size=64).astype(np.float32),
          "bias": rng.normal(size=64).astype(np.float32)}
    np.testing.assert_allclose(
        nn.layer_norm({k: _t(v) for k, v in ln.items()}, _t(x)).numpy(),
        np.asarray(rnn.layer_norm(ln, x)), **TOL)
    lin = {"w": rng.normal(size=(64, 16)).astype(np.float32),
           "b": rng.normal(size=16).astype(np.float32)}
    np.testing.assert_allclose(
        nn.linear({k: _t(v) for k, v in lin.items()}, _t(x)).numpy(),
        np.asarray(rnn.linear(lin, x)), **TOL)
    u = rng.uniform(-0.1, 1.1, size=100).astype(np.float32)
    np.testing.assert_allclose(nn.inverse_sigmoid(_t(u)).numpy(),
                               np.asarray(rnn.inverse_sigmoid(u)), **TOL)
    np.testing.assert_array_equal(nn.sine_pos_embed_2d(6, 9, 32).numpy(),
                                  np.asarray(rnn.sine_pos_embed_2d(6, 9, 32)))
    np.testing.assert_array_equal(
        nn.reference_points_for_levels(LEVELS).numpy(),
        np.asarray(rnn.reference_points_for_levels(LEVELS)))


# --------------------------------------------------------------------------
# quant
# --------------------------------------------------------------------------

def test_fake_quant_rounds_half_to_even():
    """amax = 2047 makes the 12-bit scale exactly 1, so x / s lands on
    exact .5 cases; both sides round half to even."""
    x = np.asarray([2047, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 1e-3, -2046.5],
                   np.float32)
    got = quant.fake_quant(_t(x), 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(rquant.fake_quant(x, 12)))
    np.testing.assert_array_equal(got[1:8], [0, 2, 2, -0, -2, -2, 4])
    rng = np.random.default_rng(2)
    y = rng.normal(size=(4, 33)).astype(np.float32)
    np.testing.assert_array_equal(quant.fake_quant(_t(y), 12).numpy(),
                                  np.asarray(rquant.fake_quant(y, 12)))


def test_table_quant_codes_scale_and_sentinel():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(2, 41, 4, 16)).astype(np.float32)
    v[:, -1] = 0.0                                   # zero sentinel row
    s_ref = rquant.table_quant_scale(v)
    s = quant.table_quant_scale(_t(v))
    assert s.shape == (2, 1, 4, 16) and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    codes = quant.quantize_table_rows(_t(v), s)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(rquant.quantize_table_rows(v, s_ref)))
    assert (codes[:, -1] == 0).all()
    np.testing.assert_array_equal(quant.fake_table_quant(_t(v)).numpy(),
                                  np.asarray(rquant.fake_table_quant(v)))


# --------------------------------------------------------------------------
# PAP
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "threshold", "topk"])
def test_pap_select_matches_lax_top_k_under_ties(mode):
    """Probabilities on a coarse 12-bit-like grid tie often; the stable
    top-k must pick exactly ``lax.top_k``'s indices."""
    rng = np.random.default_rng(4)
    probs = (rng.integers(0, 6, size=(2, 50, 4, 16)) / 40.0).astype(np.float32)
    probs[0, 0, 0] = 0.025                          # an all-equal row
    want = rpap.pap_select(jnp.asarray(probs), mode, threshold=0.05, k=4)
    got = pap.pap_select(_t(probs), mode, threshold=0.05, k=4)
    np.testing.assert_array_equal(got.point_idx.numpy(),
                                  np.asarray(want.point_idx))
    np.testing.assert_array_equal(got.probs.numpy(), np.asarray(want.probs))
    assert float(got.keep_frac) == pytest.approx(float(want.keep_frac), rel=1e-6)


def test_select_points_int12_within_one_quantum():
    """With INT12 fake-quant the port's probabilities may land one
    quantum (max|p| / 2047) away from the reference's where a matmul ulp
    moves x / s across a .5 boundary; nowhere more. Offsets likewise."""
    from repro.core.msdeform_attn import MSDeformAttnConfig as RCfg
    rng = np.random.default_rng(5)
    kw = dict(d_model=32, n_heads=4, pap_mode="off", act_bits=12,
              weight_bits=12, range_narrow=(6.0, 4.0, 3.0, 2.0))
    params = {"attn_w": rng.normal(size=(32, 4, 16)) * 0.3,
              "attn_b": np.zeros((4, 16)),
              "offs_w": rng.normal(size=(32, 4, 32)) * 0.3,
              "offs_b": rng.normal(size=(4, 32))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    q = rng.normal(size=(1, 60, 32)).astype(np.float32)
    r_sel, r_offs, _ = rsampling.select_points(params, RCfg(**kw), q)
    sel, offs, _ = sampling.select_points({k: _t(v) for k, v in params.items()},
                                          msda.MSDeformAttnConfig(**kw), _t(q))
    p_q = float(np.abs(np.asarray(r_sel.probs)).max()) / 2047
    assert np.abs(sel.probs.numpy() - np.asarray(r_sel.probs)).max() <= p_q * 1.001
    o_q = float(np.abs(np.asarray(r_offs)).max()) / 2047
    assert np.abs(offs.numpy() - np.asarray(r_offs)).max() <= o_q * 1.001


# --------------------------------------------------------------------------
# FWP
# --------------------------------------------------------------------------

def _sparse_freq(rng, b):
    """Integer counts with most pixels at zero: every zero pixel ties."""
    f = rng.integers(0, 5, size=(b, N_IN)).astype(np.float32)
    return np.where(rng.uniform(size=(b, N_IN)) < 0.6, 0.0, f).astype(np.float32)


def test_count_frequency_matches():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, N_IN, size=(2, 3000)).astype(np.int32)
    valid = (rng.uniform(size=(2, 3000)) < 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        fwp.count_frequency(_t(idx), _t(valid), N_IN).numpy(),
        np.asarray(rfwp.count_frequency(idx, valid, N_IN)))


FWP_CASES = [(mode, k, capacity) for mode in ("mask", "compact")
             for k, capacity in ((1.0, 0.6), (0.5, 0.3), (0.0, 1.0))]


def _fwp_freq(k, capacity):
    return _sparse_freq(np.random.default_rng(int(k * 10 + capacity * 100)), 2)


@functools.lru_cache(maxsize=None)
def _fwp_reference():
    """Every FWP case through the reference in ONE jitted call."""
    @jax.jit
    def run(freqs):
        return {c: rfwp.build_fwp_state(f, LEVELS, k=c[1], mode=c[0],
                                        capacity=c[2])
                for c, f in freqs.items()}
    return run({c: _fwp_freq(*c[1:]) for c in FWP_CASES})


@pytest.mark.parametrize("mode,k,capacity", FWP_CASES)
def test_build_fwp_state_exact_under_ties(mode, k, capacity):
    freq = _fwp_freq(k, capacity)
    want = _fwp_reference()[mode, k, capacity]
    got = fwp.build_fwp_state(_t(freq), LEVELS, k=k, mode=mode,
                              capacity=capacity)
    np.testing.assert_array_equal(got.keep_mask.numpy(),
                                  np.asarray(want.keep_mask))
    if mode == "compact":
        assert got.keep_idx.dtype == torch.int32
        np.testing.assert_array_equal(got.keep_idx.numpy(),
                                      np.asarray(want.keep_idx))
        np.testing.assert_array_equal(got.pix2slot.numpy(),
                                      np.asarray(want.pix2slot))
        cap_total = sum(rfwp.level_capacities(LEVELS, capacity))
        assert int(got.pix2slot.max()) <= cap_total     # sentinel slot
    else:
        assert got.keep_idx is None and got.pix2slot is None


# --------------------------------------------------------------------------
# MSDeformAttn oracle
# --------------------------------------------------------------------------

def _attn_case(seed, range_narrow=None):
    rng = np.random.default_rng(seed)
    kw = dict(d_model=64, n_heads=4, range_narrow=range_narrow)
    r_params = jax.tree.map(np.asarray, rmsda.init_msdeform_attn(
        jax.random.PRNGKey(seed), rmsda.MSDeformAttnConfig(**kw)))
    r_params["offs_w"] = (rng.normal(size=r_params["offs_w"].shape) * 0.1
                          ).astype(np.float32)
    q = rng.normal(size=(2, 40, 64)).astype(np.float32)
    refs = rng.uniform(0, 1, size=(2, 40, 2)).astype(np.float32)
    x = rng.normal(size=(2, N_IN, 64)).astype(np.float32)
    return kw, r_params, q, refs, x


RANGES = [None, (3.0, 2.0, 1.5, 1.0)]


@functools.lru_cache(maxsize=None)
def _oracle_reference():
    """The reference oracle for every range bound in ONE jitted call."""
    cases = [_attn_case(7, r) for r in RANGES]
    cfgs = [rmsda.MSDeformAttnConfig(**c[0]) for c in cases]

    @jax.jit
    def run(args):
        return [rmsda.msdeform_attn_ref(p, cfg, q, refs, x, LEVELS)
                for cfg, (p, q, refs, x) in zip(cfgs, args)]
    return run([c[1:] for c in cases])


@pytest.mark.parametrize("range_narrow", RANGES)
def test_msdeform_attn_ref_matches_reference_oracle(range_narrow):
    kw, r_params, q, refs, x = _attn_case(7, range_narrow)
    want = _oracle_reference()[RANGES.index(range_narrow)]
    got = msda.msdeform_attn_ref({k: _t(v) for k, v in r_params.items()},
                                 msda.MSDeformAttnConfig(**kw), _t(q),
                                 _t(refs), _t(x), LEVELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_msdeform_attn_ref_matches_grid_sample():
    """Independent cross-check: the official Deformable-DETR formulation
    through F.grid_sample (align_corners=False, zero padding)."""
    kw, r_params, q, refs, x = _attn_case(8)
    cfg = msda.MSDeformAttnConfig(**kw)
    p = {k: _t(v) for k, v in r_params.items()}
    q, refs, x = _t(q), _t(refs), _t(x)
    b, nq, d = q.shape
    h, l, npt, dh = cfg.n_heads, cfg.n_levels, cfg.n_points, cfg.head_dim
    probs = torch.softmax(torch.einsum("bnd,dhk->bnhk", q, p["attn_w"])
                          + p["attn_b"], -1).reshape(b, nq, h, l, npt)
    offs = (torch.einsum("bnd,dhk->bnhk", q, p["offs_w"]) + p["offs_b"]
            ).reshape(b, nq, h, l, npt, 2)
    v = torch.einsum("bnd,dhk->bnhk", x, p["value_w"]) + p["value_b"]
    out = torch.zeros(b * h, dh, nq)
    start = 0
    for li, (hl, wl) in enumerate(LEVELS):
        v_l = v[:, start:start + hl * wl].permute(0, 2, 3, 1).reshape(
            b * h, dh, hl, wl)
        start += hl * wl
        loc = refs[:, :, None, None, :] + offs[:, :, :, li] \
            / torch.tensor([wl, hl], dtype=torch.float32)
        grid = (2 * loc - 1).permute(0, 2, 1, 3, 4).reshape(b * h, nq, npt, 2)
        s = F.grid_sample(v_l, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                 # (BH, Dh, Nq, P)
        w = probs[:, :, :, li].permute(0, 2, 1, 3).reshape(b * h, 1, nq, npt)
        out = out + (s * w).sum(-1)
    out = out.reshape(b, h, dh, nq).permute(0, 3, 1, 2)
    want = torch.einsum("bnhk,hkd->bnd", out, p["out_w"]) + p["out_b"]
    got = msda.msdeform_attn_ref(p, cfg, q, refs, x, LEVELS)
    torch.testing.assert_close(got, want, **TOL)
