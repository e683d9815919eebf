"""K2 on the gather engine (``csrc/msgs_decode.cu``, ``msgs_gather.cuh``)
and its deterministic backward (``csrc/msgs_decode_bwd.cu``), on the CPU.

The kernels run only on the card; these tests transcribe what they do
from the C code and hold it to the reference:

  * the engine's launch grid serves every (b, layer, q, h) item of the
    stacked points once, ragged Nq, L 1 and 3, head groups of 1 and 4, and
    an item's point operands and output sit where (B, L, Nq, H, K) and
    (B, L, Nq, H, Dh) put them;
  * the staged row addressing (a head's rows start at
    ((b H/G + h/G) N_rows G + h%G) Dh and follow every G Dh elements)
    reads the same elements as ``_unstage_layout``, and with G = H it is
    K1's (b N_rows H + h) Dh;
  * a torch mirror of K2 on the engine equals the reference's
    ``msgs_decode_pallas`` / ``msgs_decode_layers_pallas`` in interpret
    mode on the toy cases of ``test_torch_decode_grad.py``: float32 rtol =
    atol = 1e-5, int8 atol 1e-5 * 127 * max scale;
  * a mirror of the backward's table gradient (the points kernel's tiles
    of one (b, h) plane's items sort their live corners by (row, slot),
    each rank taken from (row, slot), and sum each row's entries in slot
    order; the table kernel adds the tiles' partials of a row in tile
    order) places every valid live corner exactly once, in ascending slot
    order per row; its d_vp, and the tiles' scale partials' ordered sum
    d_scale, equal the
    reference's ``jax.vjp`` within test_torch_decode_grad.py's tolerances
    for the table gradient (float32 rtol = atol = 1e-5, bf16 rtol 2^-7
    plus 2^-7 of the largest entry; d_scale is the int8 table's gradient:
    a sum of hundreds of terms that cancel, in another order than
    jax.vjp's); and its d_vp is bitwise unchanged when the placement runs
    in an order shuffled from a seed (the CPU's stand-in for the card's
    thread order).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_decode_grad as toy  # noqa: E402
from repro.kernels import msgs_decode as ref_decode  # noqa: E402
from repro_torch.kernels import msgs_decode as md  # noqa: E402
from repro_torch.kernels import msgs_fused  # noqa: E402
from repro_torch.kernels.msgs_fused import gather_plan  # noqa: E402

torch.set_num_threads(1)

ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
# csrc/msgs_decode_bwd.cu: corners one points-kernel block sorts
TILE_CAP = 512


def _plan(dh, table, g, align=16):
    return gather_plan(dh, ITEMSIZE[table], align, stride=g * dh)


def _row_base(b, h, n_heads, g, n_rows, dh):
    """gather::row_base: element offset of (row 0, channel 0) of head h."""
    group = h // g
    return ((b * (n_heads // g) + group) * n_rows * g + h - group * g) * dh


def _items(b, per_batch, plan):
    """(batch, item within the batch) of every lane group gather_items runs
    with an item in range (csrc/msgs_gather.cuh)."""
    warps = -(-per_batch // plan.items_per_warp)
    blocks = -(-warps // msgs_fused.WARPS_PER_BLOCK)
    for bb in range(b):
        for bx in range(blocks):
            for w in range(msgs_fused.WARPS_PER_BLOCK):
                first = (bx * msgs_fused.WARPS_PER_BLOCK + w) * plan.items_per_warp
                for grp in range(plan.items_per_warp):
                    if first + grp < per_batch:
                        yield bb, first + grp


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("nq", [1, 19, 300])
def test_decode_grid_serves_every_item_once(nq, n_layers, g):
    b, h, k, dh, n_rows = 2, 8, 4, 32, 97
    plan = _plan(dh, "float32", g)
    per_batch = n_layers * nq * h
    seen = list(_items(b, per_batch, plan))
    assert sorted(bb * per_batch + m for bb, m in seen) == list(range(b * per_batch))
    pts = np.arange(b * n_layers * nq * h * k).reshape(b, n_layers, nq, h, k)
    out = np.arange(b * n_layers * nq * h * dh).reshape(b, n_layers, nq, h, dh)
    bases = set()
    for bb, m in seen:
        lq, hh = divmod(m, h)
        l, q = divmod(lq, nq)
        item = bb * per_batch + m
        assert pts[bb, l, q, hh, 0] == item * k            # the point operands
        assert out[bb, l, q, hh, 0] == item * dh           # the output row
        bases.add(_row_base(bb, hh, h, g, n_rows, dh))
    assert len(bases) == b * h                             # one base per (b, h)


@pytest.mark.parametrize("g,dh", [(1, 8), (4, 8), (4, 32), (2, 12)])
def test_staged_base_and_stride_address_unstage_layout(g, dh):
    rng = np.random.default_rng(g * 100 + dh)
    b, h, n_rows = 2, 8, 23
    vp = torch.from_numpy(rng.normal(size=(b, h // g, n_rows, g * dh)).astype(np.float32))
    flat = vp.reshape(-1)
    want = md._unstage_layout(vp, g, dh)
    r = torch.arange(n_rows).view(-1, 1)
    ch = torch.arange(dh).view(1, -1)
    for bb in range(b):
        for hh in range(h):
            idx = _row_base(bb, hh, h, g, n_rows, dh) + r * (g * dh) + ch
            torch.testing.assert_close(flat[idx], want[bb, :, hh], rtol=0, atol=0)
    # K1's and K3's table is the layout with G = H
    for bb in range(b):
        for hh in range(h):
            assert _row_base(bb, hh, h, h, n_rows, dh) == (bb * n_rows * h + hh) * dh


# --------------------------------------------------------------------------
# the forward: K2 on the engine, mirrored, against the Pallas kernel
# --------------------------------------------------------------------------

def _staged_rows(vp, g, dh):
    """The (B, N_rows, H, Dh) rows the engine reads from the staged table
    through its base and stride."""
    b, n_groups, n_rows, _ = vp.shape
    h = n_groups * g
    flat = vp.reshape(-1)
    r = torch.arange(n_rows).view(-1, 1)
    ch = torch.arange(dh).view(1, -1)
    return torch.stack([torch.stack([
        flat[_row_base(bb, hh, h, g, n_rows, dh) + r * (g * dh) + ch]
        for hh in range(h)], 1) for bb in range(b)])


def _corners(x, y, st, wl, hl):
    x0, y0 = torch.floor(x), torch.floor(y)
    t1, t0 = x - x0, y - y0
    pix, inside = [], []
    for c in range(4):
        cx = x0.long() + (c & 1)
        cy = y0.long() + (c >> 1)
        ok = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
        pix.append(torch.where(ok, st + cy * wl + cx, 0))
        inside.append(ok)
    return t0, t1, torch.stack(pix, -1), torch.stack(inside, -1)


def _rows(x, y, st, wl, hl, remap):
    """Phase A: the table row of every corner, -1 outside the level."""
    t0, t1, pix, inside = _corners(x, y, st.long(), wl.long(), hl.long())
    if remap is not None:
        b = pix.shape[0]
        pix = torch.gather(remap.long(), 1, pix.reshape(b, -1)).reshape(pix.shape)
    return torch.where(inside, pix, -1), t0, t1


def _engine(v4, rows, t0, t1, p, scale):
    """Phase B over (B, N, H, K) points: for k = 0, 1, ... the 4 corner rows
    of the point (pruned points load nothing), Eq. 4 in float32 in the
    engine's association, p_k S_k added in order; the scale at the end."""
    b, n_rows, h, dh = v4.shape
    vf = v4.float().reshape(b * n_rows * h, dh)
    bidx = torch.arange(b).view(b, 1, 1)
    hidx = torch.arange(h).view(1, 1, h)
    acc = torch.zeros(rows.shape[:3] + (dh,))
    for k in range(rows.shape[3]):
        n = []
        for c in range(4):
            r = torch.where(p[..., k] != 0, rows[..., k, c], -1)
            flat = ((bidx * n_rows + r.clamp(min=0)) * h + hidx).reshape(-1)
            n.append(vf[flat].reshape(r.shape + (dh,)) * (r >= 0)[..., None])
        a0, a1 = t0[..., k, None], t1[..., k, None]
        a = ((n[3] - n[2]) - n[1]) + n[0]
        s = (n[0] + (n[2] - n[0]) * a0) + ((n[1] - n[0]) + a * a0) * a1
        acc = acc + p[..., k, None] * s
    if scale is not None:
        acc = acc * scale.reshape(b, 1, h, dh)
    return acc


def _k2_mirror(vp, pts, remap, scale, g, dh):
    x, y, st, wl, hl, p = pts
    b, n_layers, nq, h, k = x.shape
    flat = lambda t: t.reshape(b, n_layers * nq, h, k)
    rows, t0, t1 = _rows(*map(flat, (x, y, st, wl, hl)), remap)
    out = _engine(_staged_rows(vp, g, dh), rows, t0, t1, flat(p), scale)
    return out.reshape(b, n_layers, nq, h, dh)


K2_CASES = [(table, compact, g, n_layers) for table in ("float32", "int8")
            for compact in (False, True) for g in (1, 4) for n_layers in (1, 3)]


@functools.lru_cache(maxsize=None)
def _k2_case(table, compact, g, n_layers):
    rng = np.random.default_rng([7, ("float32", "int8").index(table), compact, g,
                                 n_layers])
    pts = toy._points(rng, n_layers)
    vp, remap, scale = toy._table(rng, table, compact, g)
    return vp, remap, scale, pts


@functools.lru_cache(maxsize=None)
def _k2_reference():
    """Every case through the Pallas kernel in interpret mode, one jitted
    call: msgs_decode_pallas for L = 1, msgs_decode_layers_pallas else."""
    cases = {c: _k2_case(*c) for c in K2_CASES}

    @jax.jit
    def run(cases):
        out = {}
        for (table, compact, g, n_layers), (vp, remap, scale, pts) in cases.items():
            n_rows = vp.shape[2]
            staged = ref_decode.DecodeStagedTable(
                v=vp, remap=remap, scale=scale, n_rows=n_rows, head_pack=g,
                dh=toy.DH, table_bytes=0)
            if n_layers == 1:
                out[table, compact, g, n_layers] = ref_decode.msgs_decode_pallas(
                    staged, *(a[:, 0] for a in pts), block_q=8, interpret=True)[:, None]
            else:
                out[table, compact, g, n_layers] = ref_decode.msgs_decode_layers_pallas(
                    staged, *pts, block_q=8, interpret=True)
        return out
    return run(cases)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("table,compact,g,n_layers", K2_CASES)
def test_k2_engine_mirror_matches_pallas(table, compact, g, n_layers):
    vp, remap, scale, pts = _k2_case(table, compact, g, n_layers)
    got = _k2_mirror(_t(vp), [_t(a) for a in pts], _t(remap), _t(scale), g, toy.DH)
    want = np.asarray(_k2_reference()[table, compact, g, n_layers])
    atol = 1e-5 if scale is None else 1e-5 * 127 * float(np.max(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


# --------------------------------------------------------------------------
# the backward: the table gradient's bucketing and ordered sums, mirrored
# --------------------------------------------------------------------------

def _weights(t0, t1):
    """w_c = x factor * y factor, corner order (0,0) (1,0) (0,1) (1,1)."""
    u1, u0 = 1 - t1, 1 - t0
    return torch.stack([u1 * u0, t1 * u0, u1 * t0, t1 * t0], -1)


def _tile_items(dh, table, g, k):
    """Items (layers x queries) of one points-kernel tile: the 8 warps'
    items, at most TILE_CAP / (4 K) (csrc/msgs_decode_bwd.cu tile_items)."""
    plan = _plan(dh, table, g)
    return min(8 * plan.items_per_warp, TILE_CAP // (4 * k))


def _slots(pts, remap):
    """Per (b, h) plane, in slot order (layer, q, k, corner): the row each
    corner adds to (-1: none) and its coefficient p w_c."""
    x, y, st, wl, hl, p = pts
    b, n_layers, nq, h, k = x.shape
    flat = lambda t: t.reshape(b, n_layers * nq, h, k)
    rows, t0, t1 = _rows(*map(flat, (x, y, st, wl, hl)), remap)
    pf = flat(p)
    live = (rows >= 0) & (pf != 0)[..., None]
    keys = torch.where(live, rows, -1)
    coefs = torch.where(live, _weights(t0, t1) * pf[..., None], torch.zeros(()))
    plane = lambda t: t.permute(0, 2, 1, 3, 4).reshape(b, h, -1)
    return plane(keys), plane(coefs)


def _tile_list(keys, order):
    """A tile's live slots sorted by (row, slot): each slot's position is
    its rank by (row, slot), whatever ``order`` it is placed in."""
    kp = keys.numpy()
    live = np.flatnonzero(kp >= 0)
    out = np.zeros(live.size, np.int64)
    for s in order:
        if kp[s] >= 0:
            out[np.sum((kp[live] < kp[s]) | ((kp[live] == kp[s]) & (live < s)))] = s
    return out


def _plane_grad(keys, coefs, g_plane, n_rows, tile_slots, per_lq, order_seed=None):
    """One plane's d_vp rows: per tile, each row's entries summed in slot
    order; the tiles' partials added in tile order. And the tile lists."""
    dh = g_plane.shape[-1]
    out = torch.zeros((n_rows, dh))
    lists = []
    for t0 in range(0, keys.numel(), tile_slots):
        kt = keys[t0:t0 + tile_slots]
        order = np.arange(kt.numel())
        if order_seed is not None:
            np.random.default_rng(order_seed).shuffle(order)
        lst = _tile_list(kt, order) + t0
        lists.append(lst)
        part = {}
        for s in lst:
            r = int(keys[s])
            term = coefs[s] * g_plane[s // per_lq]
            part[r] = part.get(r, torch.zeros(dh)) + term
        for r, v in part.items():
            out[r] = out[r] + v
    return out, lists


def _d_vp(vp, pts, g_out, remap, g, dh, table, order_seed=None):
    keys, coefs = _slots(pts, remap)
    b, n_groups, n_rows, _ = vp.shape
    h = n_groups * g
    k = pts[0].shape[-1]
    tile_slots = _tile_items(dh, table, g, k) * 4 * k
    gf = g_out.reshape(b, -1, h, dh)
    planes = [[_plane_grad(keys[bb, hh], coefs[bb, hh], gf[bb, :, hh], n_rows,
                           tile_slots, 4 * k, order_seed) for hh in range(h)]
              for bb in range(b)]
    d4 = torch.stack([torch.stack([pl[hh][0] for hh in range(h)], 1) for pl in planes])
    return md._stage_layout(d4, g), keys, [[pl[hh][1] for hh in range(h)] for pl in planes]


def _d_scale(vp, pts, g_out, remap, scale, g, dh):
    """Per item, sum over k and c of (p w_c code_c) g per channel; per
    points-kernel tile of one (b, h), its items in order; then the tiles
    in order."""
    x, y, st, wl, hl, p = pts
    b, n_layers, nq, h, k = x.shape
    n_lq = n_layers * nq
    flat = lambda t: t.reshape(b, n_lq * h, k)
    rows, t0, t1 = _rows(*map(flat, (x, y, st, wl, hl)), remap)
    w = _weights(t0, t1) * flat(p)[..., None]
    coef = torch.where((rows >= 0) & (flat(p) != 0)[..., None], w, torch.zeros(()))
    v4 = _staged_rows(vp, g, dh).double()                     # codes
    gf = g_out.reshape(b, -1, dh).double()
    n_items = n_lq * h
    ds = torch.zeros((b, n_items, dh), dtype=torch.float64)
    for kk in range(k):
        for c in range(4):
            r = rows[..., kk, c].clamp(min=0)
            code = v4[torch.arange(b)[:, None], r, torch.arange(n_items)[None] % h]
            term = (coef[..., kk, c, None].double() * code).float().double() * gf
            ds = (ds + term).float().double()
    ds = ds.float().reshape(b, n_lq, h, dh)
    tile = _tile_items(dh, "int8", g, k)
    out = torch.zeros((b, h, dh))
    for t0 in range(0, n_lq, tile):
        part = torch.zeros((b, h, dh))
        for lq in range(t0, min(n_lq, t0 + tile)):
            part = part + ds[:, lq]
        out = out + part
    return out.reshape(scale.shape)


GRAD_CASES = [(table, compact, g, n_layers) for table in toy.TABLES
              for compact in (False, True) for g in (1, 4) for n_layers in (1, 3)]


@pytest.mark.parametrize("table,compact,g,n_layers", GRAD_CASES)
def test_table_gradient_mirror_matches_reference_vjp(table, compact, g, n_layers):
    rng = np.random.default_rng([11, toy.TABLES.index(table), compact, g, n_layers])
    pts = toy._points(rng, n_layers)
    vp, remap, scale = toy._table(rng, table, compact, g)
    g_out = rng.normal(size=(toy.B, n_layers, toy.NQ, toy.H, toy.DH)).astype(np.float32)
    want = toy._reference_vjp(vp, pts, remap, scale, g_out, g, table)
    tp = [_t(a) for a in pts]
    if table == "int8":
        # the int8 table's gradient: the table-gradient tolerance
        got = _d_scale(_t(vp), tp, _t(g_out), _t(remap), _t(scale), g, toy.DH)
        np.testing.assert_allclose(got.numpy(), want[4], rtol=1e-5, atol=1e-5)
        return
    d_vp, keys, lists = _d_vp(_t(vp), tp, _t(g_out), _t(remap), g, toy.DH, table)
    # every valid live corner exactly once, in ascending slot order per row
    for bb in range(toy.B):
        for hh in range(toy.H):
            kp = keys[bb, hh].numpy()
            assert sorted(np.concatenate(lists[bb][hh])) == list(np.flatnonzero(kp >= 0))
            for lst in lists[bb][hh]:
                rows_in = kp[lst]
                assert np.all(np.diff(rows_in) >= 0)
                assert np.all(np.diff(lst)[np.diff(rows_in) == 0] > 0)
    if table == "bfloat16":
        got = d_vp.to(torch.bfloat16).float().numpy()
        tol = dict(rtol=2 ** -7, atol=2 ** -7 * float(np.abs(want[0]).max()))
    else:
        got, tol = d_vp.numpy(), dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want[0], **tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_table_gradient_mirror_is_bitwise_unchanged_under_shuffled_placement(compact, seed):
    """30 stacked layers: each plane's 900 items span several tiles, and a
    row takes partials from several; the result still equals jax.vjp's."""
    n_layers = 30
    rng = np.random.default_rng([13, compact, seed])
    pts_np = toy._points(rng, n_layers)
    vp, remap, _ = toy._table(rng, "float32", compact, 4)
    g_np = rng.normal(size=(toy.B, n_layers, toy.NQ, toy.H, toy.DH)).astype(np.float32)
    pts, g_out = [_t(a) for a in pts_np], _t(g_np)
    first, keys, lists = _d_vp(_t(vp), pts, g_out, _t(remap), 4, toy.DH, "float32")
    again, _, lists2 = _d_vp(_t(vp), pts, g_out, _t(remap), 4, toy.DH, "float32",
                             order_seed=seed)
    assert torch.equal(first, again)
    for a, b in zip(lists, lists2):
        for la, lb in zip(a, b):
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(x, y)
    assert min(len(lp) for pl in lists for lp in pl) > 1          # several tiles
    rows_of = lambda lst, kp: set(kp[lst].tolist())
    kp = keys[0, 0].numpy()
    assert rows_of(lists[0][0][0], kp) & rows_of(lists[0][0][1], kp)
    want = toy._reference_vjp(vp, pts_np, remap, None, g_np, 4, "float32")
    np.testing.assert_allclose(first.numpy(), want[0], rtol=1e-5, atol=1e-5)


def test_backward_scratch_entry_is_declared():
    """The wrapper sizes the backward's scratch with the C entry
    msgs_decode_backward_scratch, declared like the two kernels' entries."""
    assert md.ARGTYPES["msgs_decode_backward_scratch"][-1].__name__ == "c_void_p"
    assert len(md.ARGTYPES["msgs_decode_backward"]) == 1 + 16 + 9 + 8 + 1
