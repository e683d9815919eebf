"""Kernels K1 (fused MSGS) and K2 (persistent decode) of the PyTorch port:
their plain PyTorch versions against the reference's Pallas kernels, run
as the JAX tests run them on the CPU (``repro.kernels.ops`` in interpret
mode) and against ``repro/kernels/ref.py``.

Tolerances: float32 rtol = atol = 1e-5 (the two sides sum the same terms
in another order). int8 tables: atol = 1e-5 of the code range times the
largest channel scale (1e-5 * 127 * max scale), rtol 1e-5. The staged
decode layout is a pure reshape/transpose and must be bit-identical.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import msgs_decode as ref_decode  # noqa: E402
from repro.kernels import ops as ref_ops, ref as ref_oracle  # noqa: E402
from repro_torch.kernels import msgs_decode, msgs_fused  # noqa: E402

torch.set_num_threads(1)

LEVELS = ((16, 20), (8, 10), (4, 5), (2, 3))
STARTS = np.concatenate([[0], np.cumsum([h * w for h, w in LEVELS])[:-1]])
N_PIX = sum(h * w for h, w in LEVELS)


def _points(rng, shape, zero_frac=0.0):
    """x, y, start, wl, hl, probs of ``shape`` with random levels;
    coordinates spill past every level edge."""
    lvl = rng.integers(0, len(LEVELS), shape)
    wl = np.asarray([w for _, w in LEVELS], np.int32)[lvl]
    hl = np.asarray([h for h, _ in LEVELS], np.int32)[lvl]
    st = STARTS.astype(np.int32)[lvl]
    x = (rng.uniform(-1.5, 1.0, shape) * 1.0 + rng.uniform(0, 1, shape) * (wl + 1)
         ).astype(np.float32)
    y = (rng.uniform(-1.5, 1.0, shape) * 1.0 + rng.uniform(0, 1, shape) * (hl + 1)
         ).astype(np.float32)
    logits = rng.normal(size=shape)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if zero_frac:
        p = np.where(rng.uniform(size=shape) < zero_frac, 0.0, p)
    return x, y, st, wl, hl, p.astype(np.float32)


def _table(rng, b, n_rows, h, dh, kind, sentinel):
    """(v, scale): float32 values or int8 codes + (B,1,H,Dh) scale; the
    last row is the zero sentinel (code 0) when ``sentinel``."""
    if kind == "f32":
        v = rng.normal(size=(b, n_rows, h, dh)).astype(np.float32)
        scale = None
    else:
        v = rng.integers(-127, 128, (b, n_rows, h, dh)).astype(np.int8)
        scale = rng.uniform(0.005, 0.02, (b, 1, h, dh)).astype(np.float32)
    if sentinel:
        v[:, -1] = 0
    return v, scale


def _remap(rng, b, n_rows):
    """A pixel -> row map that sends about a third of the pixels to the
    sentinel row n_rows - 1."""
    m = rng.integers(0, n_rows - 1, (b, N_PIX))
    m = np.where(rng.uniform(size=(b, N_PIX)) < 0.35, n_rows - 1, m)
    return m.astype(np.int32)


def _tol(scale):
    if scale is None:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-5 * 127 * float(scale.max()))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# K1 — msgs_fused / msgs_fused_packed
# --------------------------------------------------------------------------

K1_CASES = [(entry, layout, kind) for entry in ("fused", "packed")
            for layout in ("dense", "compact") for kind in ("f32", "int8")]


@functools.lru_cache(maxsize=None)
def _k1_case(entry, layout, kind):
    rng = np.random.default_rng(
        [entry == "packed", layout == "compact", kind == "int8"])
    # packed: 4 heads of Dh 32 share one 128-lane row (G = 4, main path)
    b, nq, h, k, dh = (2, 24, 4, 8, 16) if entry == "fused" else (1, 20, 4, 4, 32)
    compact = layout == "compact"
    n_rows = 300 if compact else N_PIX
    v, scale = _table(rng, b, n_rows, h, dh, kind, sentinel=compact)
    remap = _remap(rng, b, n_rows) if compact else None
    return v, scale, remap, _points(rng, (b, nq, h, k))


@functools.lru_cache(maxsize=None)
def _k1_reference():
    """Every K1 case through the reference's Pallas kernels (interpret
    mode) in ONE jitted call: one compile instead of one per case."""
    @jax.jit
    def run(cases):
        out = {}
        for (entry, layout, kind), (v, scale, remap, pts) in cases.items():
            if entry == "fused":
                out[entry, layout, kind] = ref_ops.msgs_fused(
                    v, *pts, remap=remap, scale=scale, block_q=32)
            else:
                out[entry, layout, kind] = ref_ops.msgs_fused_packed(
                    v, *pts, remap=remap, scale=scale, head_pack=4,
                    block_q=32)
        return out
    return run({c: _k1_case(*c) for c in K1_CASES})


@pytest.mark.parametrize("entry,layout,kind", K1_CASES)
def test_k1_plain_matches_pallas(entry, layout, kind):
    v, scale, remap, pts = _k1_case(entry, layout, kind)
    args = (_t(v), *map(_t, pts))
    if entry == "fused":
        got = msgs_fused.msgs_fused(*args, remap=_t(remap), scale=_t(scale))
    else:
        got = msgs_fused.msgs_fused_packed(*args, remap=_t(remap),
                                           scale=_t(scale), head_pack=4)
    b, nq, h, _ = pts[0].shape
    assert got.dtype == torch.float32 and got.shape == (b, nq, h, v.shape[3])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_k1_reference()[entry, layout, kind]),
                               **_tol(scale))


def test_k1_plain_matches_jnp_oracle_ragged():
    """A ragged Nq (37 queries, not a multiple of the reference's 16-query
    tile) against the reference kernel and against the pure-jnp oracle."""
    rng = np.random.default_rng(7)
    b, nq, h, k, dh = 1, 37, 2, 16, 32
    v, _ = _table(rng, b, N_PIX, h, dh, "f32", sentinel=False)
    pts = _points(rng, (b, nq, h, k))
    got = msgs_fused.msgs_fused(_t(v), *map(_t, pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_ops.msgs_fused(
        v, *pts, block_q=16)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref_oracle.msgs_fused_ref(
        v, *pts)), rtol=1e-5, atol=1e-5)


def test_k1_zero_probabilities_prune_exactly():
    """PAP-pruned points (p == 0) contribute exactly nothing: the output
    equals the sum over the surviving points alone."""
    rng = np.random.default_rng(8)
    b, nq, h, k, dh = 1, 20, 2, 8, 16
    v, _ = _table(rng, b, N_PIX, h, dh, "f32", sentinel=False)
    x, y, st, wl, hl, p = _points(rng, (b, nq, h, k), zero_frac=0.5)
    got = msgs_fused.msgs_fused(_t(v), *map(_t, (x, y, st, wl, hl, p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_ops.msgs_fused(
        v, x, y, st, wl, hl, p, block_q=16)), rtol=1e-5, atol=1e-5)
    # move every pruned point far outside its level: nothing may change
    far = np.where(p == 0, -1e4, x).astype(np.float32)
    moved = msgs_fused.msgs_fused(_t(v), *map(_t, (far, y, st, wl, hl, p)))
    assert torch.equal(moved, got)


def test_k1_bf16_table_matches_f32_on_the_same_values():
    """A bf16 table returns bf16, and equals the f32 computation on the
    same (bf16-representable) values up to the output's bf16 rounding."""
    rng = np.random.default_rng(9)
    b, nq, h, k, dh = 1, 16, 2, 4, 32
    v32 = torch.from_numpy(rng.normal(size=(b, N_PIX, h, dh)).astype(np.float32))
    v16 = v32.to(torch.bfloat16)
    pts = tuple(map(_t, _points(rng, (b, nq, h, k))))
    out16 = msgs_fused.msgs_fused(v16, *pts)
    out32 = msgs_fused.msgs_fused(v16.to(torch.float32), *pts)
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), out32, rtol=2 ** -7, atol=1e-6)


# --------------------------------------------------------------------------
# K2 — stage_decode_table / msgs_decode / msgs_decode_layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("head_pack", [1, 4])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k2_staging_is_bit_identical(head_pack, kind):
    rng = np.random.default_rng(head_pack * 10 + (kind == "int8"))
    b, n_rows, h, dh = 2, 57, 4, 32
    v, scale = _table(rng, b, n_rows, h, dh, kind, sentinel=True)
    remap = _remap(rng, b, n_rows)
    want = ref_decode.stage_decode_table(v, remap, head_pack=head_pack,
                                         scale=scale)
    got = msgs_decode.stage_decode_table(_t(v), _t(remap),
                                         head_pack=head_pack, scale=_t(scale))
    assert got.v.dtype == _t(v).dtype
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_equal(got.remap.numpy(), np.asarray(want.remap))
    if scale is not None:
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.n_rows, got.head_pack, got.dh, got.table_bytes) == \
        (want.n_rows, want.head_pack, want.dh, want.table_bytes)


@functools.lru_cache(maxsize=None)
def _decode_case(seed, layout, kind, n_layers):
    """Main-path packed staging (H = 4, Dh = 32, G = 4) and stacked points."""
    rng = np.random.default_rng(seed)
    b, nq, h, k, dh, g = 2, 30, 4, 4, 32, 4
    compact = layout == "compact"
    n_rows = 250 if compact else N_PIX
    v, scale = _table(rng, b, n_rows, h, dh, kind, sentinel=compact)
    remap = _remap(rng, b, n_rows) if compact else None
    ref_staged = ref_decode.stage_decode_table(v, remap, head_pack=g,
                                               scale=scale)
    staged = msgs_decode.stage_decode_table(_t(v), _t(remap), head_pack=g,
                                            scale=_t(scale))
    return ref_staged, staged, _points(rng, (b, n_layers, nq, h, k)), scale


K2_PALLAS = [("int8", 1), ("f32", 2)]
K2_JNP = [(layout, kind) for layout in ("dense", "compact")
          for kind in ("f32", "int8")]


@functools.lru_cache(maxsize=None)
def _k2_reference():
    """The K2 reference outputs in ONE jitted call: ``msgs_decode`` (one
    layer, int8) and ``msgs_decode_layers`` (L = 2, f32) in interpret
    mode on compact tables, and ``msgs_decode_ref`` — the jnp function
    the reference's custom_vjp is built on — for L = 2 over {dense,
    compact} x {f32, int8}."""
    pallas = {c: _decode_case(100 + c[1], "compact", *c) for c in K2_PALLAS}
    jnp_cases = {c: _decode_case(200 + 2 * (c[0] == "compact")
                                 + (c[1] == "int8"), *c, 2) for c in K2_JNP}

    @jax.jit
    def run(pallas, jnp_cases):
        out = {}
        for (kind, n_layers), (staged, _, pts, _) in pallas.items():
            if n_layers == 1:
                out[kind, n_layers] = ref_ops.msgs_decode(
                    staged, *(a[:, 0] for a in pts), block_q=32)
            else:
                out[kind, n_layers] = ref_ops.msgs_decode_layers(
                    staged, *pts, block_q=32)
        for key, (staged, _, pts, _) in jnp_cases.items():
            out[key] = ref_decode.msgs_decode_ref(
                staged.v, *pts, staged.remap, staged.scale,
                head_pack=staged.head_pack, dh=staged.dh)
        return out
    strip = lambda cases: {k: (c[0], None, c[2], None) for k, c in cases.items()}
    return pallas, jnp_cases, run(strip(pallas), strip(jnp_cases))


@pytest.mark.parametrize("kind,n_layers", K2_PALLAS)
def test_k2_plain_matches_pallas(kind, n_layers):
    """msgs_decode (one layer, int8) and msgs_decode_layers (L = 2, f32)
    on a compact table against the Pallas kernel in interpret mode."""
    pallas, _, want = _k2_reference()
    _, staged, pts, scale = pallas[kind, n_layers]
    want = want[kind, n_layers]
    if n_layers == 1:
        got = msgs_decode.msgs_decode(staged, *(_t(a[:, 0]) for a in pts))
    else:
        got = msgs_decode.msgs_decode_layers(staged, *map(_t, pts))
    assert got.shape == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(scale))


@pytest.mark.parametrize("layout,kind", K2_JNP)
def test_k2_layers_match_jnp_reference(layout, kind):
    """msgs_decode_layers with L = 2 against the reference's
    ``msgs_decode_ref``."""
    _, jnp_cases, want = _k2_reference()
    _, staged, pts, scale = jnp_cases[layout, kind]
    got = msgs_decode.msgs_decode_layers(staged, *map(_t, pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[layout, kind]),
                               **_tol(scale))


def test_k2_plain_agrees_with_k1_plain():
    """The decode kernel's function equals the fused kernel's on the
    unstaged table (same points, one layer)."""
    rng = np.random.default_rng(11)
    b, nq, h, k, dh = 2, 30, 8, 4, 32
    v, scale = _table(rng, b, 200, h, dh, "int8", sentinel=True)
    remap = _remap(rng, b, 200)
    pts = tuple(map(_t, _points(rng, (b, nq, h, k))))
    staged = msgs_decode.stage_decode_table(_t(v), _t(remap), head_pack=4,
                                            scale=_t(scale))
    np.testing.assert_allclose(
        msgs_decode.msgs_decode(staged, *pts).numpy(),
        msgs_fused.msgs_fused(_t(v), *pts, remap=_t(remap),
                              scale=_t(scale)).numpy(), **_tol(scale))
