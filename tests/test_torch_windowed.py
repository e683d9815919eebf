"""Kernel K3 of the PyTorch port (windowed multi-scale-parallel MSGS)
against the reference's ``msgs_windowed_msp_pallas``, and the plan
fields that describe its windows.

  * ``window_geometry`` equals the reference's field by field, with the
    same ``slot_windows`` and ``staged_bytes``, on the toy pyramid, the
    paper's 800x1333 pyramid and the 512 / 1024 px buckets;
  * ``repack_queries`` / ``unpack_queries`` equal the reference's and
    round-trip;
  * ``msgs_windowed_msp_plain`` (what the wrapper runs on CPU tensors)
    against the Pallas kernel in interpret mode, with points spread up to
    three range bounds around their reference, so that the windows drop
    some corners. Tolerances: float32 rtol = atol = 1e-5 (the same terms
    summed in another order); int8 atol 1e-5 * 127 * max scale;
  * the plan's ``tile_q`` / ``window_bytes`` / ``window_bytes_compact``
    equal the reference plan's, and a ``cuda_windowed`` request without
    range narrowing, or decode-shaped, raises.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import msda as rmsda  # noqa: E402
from repro.configs.detr_family import LEVEL_SHAPES  # noqa: E402
from repro.core import fwp as rfwp, msdeform_attn as rattn  # noqa: E402
from repro.kernels import msgs_windowed as rwin, ops as ref_ops  # noqa: E402
from repro.msda import plan as rplan  # noqa: E402
from repro_torch import msda  # noqa: E402
from repro_torch.core.msdeform_attn import MSDeformAttnConfig  # noqa: E402
from repro_torch.kernels import msgs_fused, msgs_windowed  # noqa: E402

torch.set_num_threads(1)

TOY = ((16, 20), (8, 10), (4, 5), (2, 3))
BUCKETS = {"toy": TOY, "paper": tuple(LEVEL_SHAPES),
           "512px": tuple((512 // s, 512 // s) for s in (4, 8, 16, 32)),
           "1024px": tuple((1024 // s, 1024 // s) for s in (4, 8, 16, 32))}
RANGES = {"defa": (16.0, 12.0, 8.0, 4.0), "offgrid": (5.7, 3.9, 2.6, 1.7)}


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tile_q", [8, 64, 128])
@pytest.mark.parametrize("ranges", sorted(RANGES))
@pytest.mark.parametrize("bucket", sorted(BUCKETS))
def test_window_geometry_equals_reference(bucket, ranges, tile_q):
    levels, rngs = BUCKETS[bucket], RANGES[ranges]
    want = rwin.window_geometry(levels, rngs, tile_q)
    got = msgs_windowed.window_geometry(levels, rngs, tile_q)
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    caps = rfwp.level_capacities(levels, 0.6)
    assert got.slot_windows(caps) == want.slot_windows(caps)
    for lanes, itemsize in ((128, 1), (128, 4), (32, 2)):
        assert got.staged_bytes(lanes, itemsize) == \
            want.staged_bytes(lanes, itemsize)
        assert got.staged_bytes(lanes, itemsize, caps=caps) == \
            want.staged_bytes(lanes, itemsize, caps=caps)
    first, count = msgs_windowed.tile_spans(got)
    assert len(first) == got.n_tiles and int(count.sum()) == got.n_in
    np.testing.assert_array_equal(first[1:], first[:-1] + count[:-1])


@pytest.mark.parametrize("tile_q", [8, 128])
def test_repack_unpack_equal_reference_and_round_trip(tile_q):
    geo = msgs_windowed.window_geometry(TOY, RANGES["offgrid"], tile_q)
    rgeo = rwin.window_geometry(TOY, RANGES["offgrid"], tile_q)
    a = np.random.default_rng(tile_q).integers(
        0, 4, (2, geo.n_in, 3, 4)).astype(np.int32)
    packed = msgs_windowed.repack_queries(geo, _t(a), fill=-1)
    want = np.asarray(rwin.repack_queries(rgeo, a, fill=-1))
    assert packed.shape == (2, geo.nq_padded, 3, 4)
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        msgs_windowed.unpack_queries(geo, packed).numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(rwin.unpack_queries(rgeo, want)), a)


# --------------------------------------------------------------------------
# msgs_windowed_msp_plain against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

K3_RANGES = (2.5, 1.8, 1.2, 0.7)   # narrow: the windows drop many corners
K3_TILE = 64
K3_CASES = [(kind, layout, hp) for kind in ("f32", "int8")
            for layout in ("dense", "compact") for hp in (1, 4)]


def _refs(levels):
    out = []
    for h, w in levels:
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                             indexing="ij")
        out.append(np.stack([xs.ravel(), ys.ravel()], -1))
    return np.concatenate(out)


def _compact(rng, b):
    """An FWP-like compact table layout: per level a raster-sorted keep
    list of the level's capacity, a third of its pixels not surviving
    (routed to the sentinel slot), and the pixel -> slot map."""
    caps = rfwp.level_capacities(TOY, 0.6)
    starts = np.concatenate([[0], np.cumsum([h * w for h, w in TOY])[:-1]])
    n_in, cap = sum(h * w for h, w in TOY), sum(caps)
    keep = np.zeros((b, cap), np.int32)
    remap = np.full((b, n_in), cap, np.int32)
    for bi in range(b):
        off = 0
        for (h, w), s, c in zip(TOY, starts, caps):
            idx = np.sort(rng.choice(h * w, c, replace=False)) + s
            keep[bi, off:off + c] = idx
            alive = rng.uniform(size=c) > 0.3
            remap[bi, idx[alive]] = np.arange(off, off + c)[alive]
            off += c
    return keep, remap, tuple(caps), cap + 1


@functools.lru_cache(maxsize=None)
def _k3_case(kind, layout, hp):
    rng = np.random.default_rng([kind == "int8", layout == "compact", hp])
    b, h, k, dh = 2, 4, 4, 32 if hp == 4 else 16
    n_in = sum(a * c for a, c in TOY)
    lvl = rng.integers(0, len(TOY), (b, n_in, h, k)).astype(np.int32)
    wl = np.asarray([w for _, w in TOY])[lvl]
    hl = np.asarray([a for a, _ in TOY])[lvl]
    bound = np.asarray(K3_RANGES)[lvl]
    refs = _refs(TOY)
    x = (refs[None, :, None, None, 0] * wl - 0.5
         + rng.uniform(-3, 3, lvl.shape) * bound).astype(np.float32)
    y = (refs[None, :, None, None, 1] * hl - 0.5
         + rng.uniform(-3, 3, lvl.shape) * bound).astype(np.float32)
    p = rng.uniform(0, 1, lvl.shape)
    p = np.where(rng.uniform(size=lvl.shape) < 0.1, 0.0, p).astype(np.float32)
    keep = remap = caps = None
    n_rows = n_in
    if layout == "compact":
        keep, remap, caps, n_rows = _compact(rng, b)
    if kind == "f32":
        v = rng.normal(size=(b, n_rows, h, dh)).astype(np.float32)
        scale = None
    else:
        v = rng.integers(-127, 128, (b, n_rows, h, dh)).astype(np.int8)
        scale = rng.uniform(0.005, 0.02, (b, h // hp, hp, dh)).astype(np.float32)
    if layout == "compact":
        v[:, -1] = 0                                  # the zero sentinel row
    return dict(v=v, x=x, y=y, lvl=lvl, p=p, remap=remap, keep=keep,
                scale=scale, caps=caps, hp=hp)


@functools.lru_cache(maxsize=None)
def _k3_reference():
    """Every K3 case through the Pallas kernel (interpret mode) in ONE
    jitted call: one compile instead of one per case."""
    cases = {c: _k3_case(*c) for c in K3_CASES}
    arrays = {c: {n: d[n] for n in ("v", "x", "y", "lvl", "p", "remap",
                                    "keep", "scale")}
              for c, d in cases.items()}

    @jax.jit
    def run(arrays):
        out = {}
        for c, a in arrays.items():
            out[c] = ref_ops.msgs_windowed_msp(
                a["v"], a["x"], a["y"], a["lvl"], a["p"], remap=a["remap"],
                keep_idx=a["keep"], scale=a["scale"], level_shapes=TOY,
                ranges=K3_RANGES, tile_q=K3_TILE, head_pack=cases[c]["hp"],
                caps=cases[c]["caps"])
        return out
    return run(arrays)


def _k3_port(d, fn=msgs_windowed.msgs_windowed_msp):
    return fn(_t(d["v"]), _t(d["x"]), _t(d["y"]), _t(d["lvl"]), _t(d["p"]),
              remap=_t(d["remap"]), keep_idx=_t(d["keep"]),
              scale=_t(d["scale"]), level_shapes=TOY, ranges=K3_RANGES,
              tile_q=K3_TILE, head_pack=d["hp"], caps=d["caps"])


@pytest.mark.parametrize("kind,layout,hp", K3_CASES)
def test_k3_plain_matches_pallas(kind, layout, hp):
    d = _k3_case(kind, layout, hp)
    got = _k3_port(d)
    b, n_in, h, _ = d["x"].shape
    assert got.dtype == torch.float32 and got.shape == (b, n_in, h,
                                                        d["v"].shape[3])
    tol = dict(rtol=1e-5, atol=1e-5)
    if d["scale"] is not None:
        tol["atol"] = 1e-5 * 127 * float(d["scale"].max())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_k3_reference()[kind, layout, hp]),
                               **tol)
    # the windows decide: K1 (no windows) on the same operands differs
    st = np.asarray(msgs_windowed.window_geometry(TOY, K3_RANGES, K3_TILE)
                    .level_starts, np.int32)[d["lvl"]]
    wl = np.asarray([w for _, w in TOY], np.int32)[d["lvl"]]
    hl = np.asarray([a for a, _ in TOY], np.int32)[d["lvl"]]
    scale = None if d["scale"] is None else \
        _t(d["scale"]).reshape(b, 1, h, -1).contiguous()
    k1 = msgs_fused.msgs_fused(_t(d["v"]), _t(d["x"]), _t(d["y"]), _t(st),
                               _t(wl), _t(hl), _t(d["p"]), remap=_t(d["remap"]),
                               scale=scale)
    dropped = (k1 - got).abs().amax(-1) > 1e-3
    assert 0.01 < float(dropped.float().mean()) < 0.5


def test_k3_plain_equals_k1_when_the_windows_cover_every_point():
    """Points within their range bounds: no corner leaves its tile's
    window, so K3 computes K1's function exactly (up to summation order)."""
    d = dict(_k3_case("f32", "compact", 4))
    lvl = d["lvl"]
    bound = np.asarray(K3_RANGES)[lvl]
    rng = np.random.default_rng(5)
    refs = _refs(TOY)
    wl = np.asarray([w for _, w in TOY], np.int32)[lvl]
    hl = np.asarray([a for a, _ in TOY], np.int32)[lvl]
    d["x"] = (refs[None, :, None, None, 0] * wl - 0.5
              + rng.uniform(-1, 1, lvl.shape) * bound).astype(np.float32)
    d["y"] = (refs[None, :, None, None, 1] * hl - 0.5
              + rng.uniform(-1, 1, lvl.shape) * bound).astype(np.float32)
    st = np.asarray(msgs_windowed.window_geometry(TOY, K3_RANGES, K3_TILE)
                    .level_starts, np.int32)[lvl]
    k1 = msgs_fused.msgs_fused(_t(d["v"]), _t(d["x"]), _t(d["y"]), _t(st),
                               _t(wl), _t(hl), _t(d["p"]), remap=_t(d["remap"]))
    np.testing.assert_allclose(_k3_port(d).numpy(), k1.numpy(), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

PLAN_CASES = [("toy", 64, 4, "float32", "compact"),
              ("toy", 64, 4, "int8", "off"),
              ("1024px", 256, 8, "int8", "compact"),
              ("1024px", 256, 8, "float32", "compact"),
              ("512px", 256, 2, "bfloat16", "mask")]


@pytest.mark.parametrize("bucket,d_model,heads,table,fwp", PLAN_CASES)
def test_plan_window_fields_equal_reference(bucket, d_model, heads, table, fwp):
    levels = BUCKETS[bucket]
    kw = dict(d_model=d_model, n_heads=heads, range_narrow=RANGES["defa"],
              fwp_mode=fwp, fwp_capacity=0.6, table_dtype=table)
    want = rmsda.make_plan(rattn.MSDeformAttnConfig(**kw), levels,
                           backend="pallas_windowed")
    got = msda.make_plan(MSDeformAttnConfig(**kw), levels,
                         backend="cuda_windowed")
    assert got.backend == "cuda_windowed"
    assert (got.tile_q, got.window_bytes, got.window_bytes_compact) == \
        (want.tile_q, want.window_bytes, want.window_bytes_compact)
    assert got.head_pack == want.head_pack
    dec = msda.make_plan(MSDeformAttnConfig(**kw), levels, n_queries=300)
    rdec = rmsda.make_plan(rattn.MSDeformAttnConfig(**kw), levels,
                           n_queries=300)
    assert (dec.tile_q, dec.window_bytes) == (rdec.tile_q, rdec.window_bytes)
    assert msda.block_q_for_levels(levels, 128) == \
        rplan.block_q_for_levels(levels, 128)


def test_cuda_windowed_plan_rejects_what_it_cannot_run():
    cfg = MSDeformAttnConfig(d_model=64, n_heads=4)
    assert not msda.windowed_eligible(cfg)
    with pytest.raises(ValueError, match="range_narrow"):
        msda.make_plan(cfg, TOY, backend="cuda_windowed")
    narrow = MSDeformAttnConfig(d_model=64, n_heads=4,
                                range_narrow=RANGES["defa"])
    with pytest.raises(ValueError, match="raster encoder queries"):
        msda.make_plan(narrow, TOY, backend="cuda_windowed", n_queries=30)
    assert msda.backend_info("cuda_windowed").raster_only
    assert msda.make_plan(narrow, TOY, backend="auto").backend == "cuda_fused"
