"""The gather engine of K1 and K3 (``csrc/msgs_gather.cuh``), on the CPU.

The kernels run only on the card; what surrounds them is host Python that
these tests reach:

  * ``gather_plan`` covers every channel of a row exactly once, with a
    vector width that divides the row and the table pointer, for Dh in
    {12, 16, 32, 64, 128} x {float32, bfloat16, int8} and for misaligned
    and odd-width rows;
  * the launch grid (transcribed from csrc/msgs_gather.cuh) serves every
    (b, q, h) item once, ragged Nq included;
  * K3's arithmetic query -> tile map equals ``tile_spans`` on the 512 and
    1024 px pyramids and a ragged toy one;
  * the plan keeps at least 32 KB of corner-row loads in flight per SM at
    both encoder paths' shapes (132 SMs, H100 SXM), and the wrappers
    refuse sizes the kernels cannot count;
  * a torch mirror of the engine (per point: the 4 corners resolved
    together, remap read from the whole pixel axis, K3's windows as
    arithmetic on the query's tile; rows gathered vector by vector as the
    plan says; the sum over k in the order k = 0, 1, ...) equals the
    reference's Pallas kernels in interpret mode on the toy cases of
    ``test_torch_kernels.py`` and ``test_torch_windowed.py``, at their
    tolerances: float32 rtol = atol = 1e-5, int8 atol 1e-5 * 127 * max
    scale.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import test_torch_kernels as k1_cases  # noqa: E402
import test_torch_windowed as k3_cases  # noqa: E402
from repro_torch.kernels import msgs_fused, msgs_windowed  # noqa: E402
from repro_torch.kernels.msgs_fused import gather_plan  # noqa: E402

torch.set_num_threads(1)

H100_SMS = 132
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
PYRAMIDS = {"512px": tuple((512 // s, 512 // s) for s in (4, 8, 16, 32)),
            "1024px": tuple((1024 // s, 1024 // s) for s in (4, 8, 16, 32)),
            "ragged": ((13, 17), (7, 9), (4, 5), (2, 3))}


def _grid_x(per_batch, plan):
    """gather::grid_blocks: blocks of WARPS_PER_BLOCK warps along grid x
    for one batch; grid y is the batch."""
    warps = -(-per_batch // plan.items_per_warp)
    return -(-warps // msgs_fused.WARPS_PER_BLOCK)


def _warp_items(b, per_batch, plan):
    """(batch, flat item) of every lane group gather_items runs with an
    item in range: warp w of block (bx, batch) serves the batch's items
    (bx * WARPS_PER_BLOCK + w) * items_per_warp + group."""
    for bb in range(b):
        for bx in range(_grid_x(per_batch, plan)):
            for w in range(msgs_fused.WARPS_PER_BLOCK):
                first = (bx * msgs_fused.WARPS_PER_BLOCK + w) * plan.items_per_warp
                for g in range(plan.items_per_warp):
                    if first + g < per_batch:
                        yield bb, bb * per_batch + first + g


def _row_bytes_in_flight(plan, k, n_items, sms):
    """Corner-row bytes one SM has in flight in phase B: the warps it holds
    at least (MIN_BLOCKS_PER_SM blocks of WARPS_PER_BLOCK, fewer when the
    grid is small), each with every group's 4 corners of min(k,
    POINTS_PER_PASS) points loading one vector per active lane."""
    warps = -(-n_items // plan.items_per_warp)
    per_sm = min(msgs_fused.MIN_BLOCKS_PER_SM * msgs_fused.WARPS_PER_BLOCK,
                 -(-warps // sms))
    lanes = plan.items_per_warp * min(plan.lanes_per_row, plan.group_lanes)
    return per_sm * lanes * 4 * min(k, msgs_fused.POINTS_PER_PASS) * plan.vec_bytes


def _covered(plan):
    """{channel: times covered} over every lane of a group and every row
    chunk, as gather_items walks them."""
    seen = {}
    for r in range(plan.row_chunks):
        for i in range(plan.group_lanes):
            vec = i + plan.group_lanes * r
            if vec >= plan.lanes_per_row:
                continue
            for c in range(vec * plan.channels_per_lane,
                           (vec + 1) * plan.channels_per_lane):
                seen[c] = seen.get(c, 0) + 1
    return seen


def _check_plan(plan, dh, itemsize, align):
    row = dh * itemsize
    assert plan.vec_bytes in (16, 8, 4, 2, 1)
    assert plan.vec_bytes >= itemsize and row % plan.vec_bytes == 0
    assert align % plan.vec_bytes == 0
    assert plan.lanes_per_row == row // plan.vec_bytes
    assert plan.group_lanes & (plan.group_lanes - 1) == 0
    assert plan.group_lanes * plan.items_per_warp == 32
    assert plan.channels_per_lane * itemsize == plan.vec_bytes
    assert _covered(plan) == {c: 1 for c in range(dh)}


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("dh", [12, 16, 32, 64, 128])
def test_gather_plan_covers_every_channel_once(dh, dtype):
    itemsize = ITEMSIZE[dtype]
    plan = gather_plan(dh, itemsize)
    _check_plan(plan, dh, itemsize, 16)
    # a row that is a multiple of 16 B takes 16 B vectors; Dh 12 takes the
    # widest that divides 12 * itemsize, never the plain version
    assert plan.vec_bytes == (16 if dh * itemsize % 16 == 0
                              else {4: 16, 2: 8, 1: 4}[itemsize])
    assert plan.row_chunks == 1


@pytest.mark.parametrize("dh,dtype,align", [
    (32, "float32", 4), (32, "bfloat16", 2), (32, "int8", 1), (64, "int8", 8),
    (7, "float32", 16), (125, "int8", 16), (127, "bfloat16", 16),
    (100, "float32", 16)])
def test_gather_plan_narrows_for_misaligned_and_odd_rows(dh, dtype, align):
    """A table pointer aligned to fewer than 16 bytes, or a row whose
    bytes are odd, takes a narrower vector of the same engine; a row of
    more vectors than a warp has lanes takes several row chunks."""
    itemsize = ITEMSIZE[dtype]
    plan = gather_plan(dh, itemsize, align)
    _check_plan(plan, dh, itemsize, align)
    if plan.lanes_per_row > 32:
        assert plan.group_lanes == 32 and plan.row_chunks > 1


def test_pointer_alignment_reads_the_address():
    base = torch.zeros(64, dtype=torch.int8)
    assert base.data_ptr() % 16 == 0
    for offset, want in ((0, 16), (16, 16), (1, 1), (2, 2), (4, 4), (8, 8),
                         (12, 4), (40, 8)):
        assert msgs_fused.pointer_alignment(base[offset:]) == want


@pytest.mark.parametrize("dh,itemsize", [(32, 4), (32, 1), (12, 4), (16, 1),
                                         (128, 4)])
@pytest.mark.parametrize("b,nq,h", [(2, 37, 4), (1, 1, 8), (2, 21760, 8),
                                    (3, 5, 2)])
def test_gather_grid_serves_every_item_once(b, nq, h, dh, itemsize):
    plan = gather_plan(dh, itemsize)
    per_batch = nq * h
    items = list(_warp_items(b, per_batch, plan))
    assert sorted(it for _, it in items) == list(range(b * per_batch))
    assert all(it // per_batch == bb for bb, it in items)
    blocks = _grid_x(per_batch, plan)
    per_block = msgs_fused.WARPS_PER_BLOCK * plan.items_per_warp
    assert (blocks - 1) * per_block < per_batch <= blocks * per_block


@pytest.mark.parametrize("tile_q", [8, 64, 128])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_query_tiles_equal_tile_spans(pyramid, tile_q):
    geo = msgs_windowed.window_geometry(PYRAMIDS[pyramid],
                                        (16.0, 12.0, 8.0, 4.0), tile_q)
    first, count = msgs_windowed.tile_spans(geo)
    want = np.repeat(np.arange(geo.n_tiles), count)
    np.testing.assert_array_equal(msgs_windowed.query_tiles(geo), want)
    np.testing.assert_array_equal(
        first, [np.flatnonzero(want == t)[0] for t in range(geo.n_tiles)])


@pytest.mark.parametrize("path,dh,itemsize,n_items", [
    ("512px_f32", 32, 4, 2 * 21760 * 8),
    ("1024px_int8", 32, 1, 2 * 87040 * 8)])
def test_plan_keeps_32kb_of_rows_in_flight_per_sm(path, dh, itemsize, n_items):
    plan = gather_plan(dh, itemsize)
    assert _row_bytes_in_flight(plan, 4, n_items, H100_SMS) >= 32 * 1024


@pytest.mark.parametrize("nq,h,dh", [(2 ** 28, 8, 32), (1, 2 ** 22, 128)])
def test_wrappers_refuse_sizes_the_kernel_cannot_count(nq, h, dh):
    """Beyond 2^31 (q, h) items per batch, or a 2 GB table row, the kernels'
    31-bit counts would overflow: the wrappers raise instead."""
    with pytest.raises(ValueError, match="the kernel counts at most"):
        msgs_fused.check_gather_sizes(nq * h, h * dh * 4, "msgs_fused")
    msgs_fused.check_gather_sizes(21760 * 8, 8 * 32 * 4, "msgs_fused")


# --------------------------------------------------------------------------
# the engine mirrored in torch, against the reference's Pallas kernels
# --------------------------------------------------------------------------

def _corners(x, y, st, wl, hl):
    """Fractions and, per corner (0,0) (1,0) (0,1) (1,1), the flat pixel
    and whether it lies inside the level."""
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


def _remapped(remap, pix):
    b = pix.shape[0]
    return torch.gather(remap.long(), 1, pix.reshape(b, -1)).reshape(pix.shape)


def _fused_points(x, y, st, wl, hl, p, remap):
    """K1's phase A: rows (B, Nq, H, K, 4), -1 where a corner is dropped."""
    t0, t1, pix, inside = _corners(x, y, st.long(), wl.long(), hl.long())
    rows = pix if remap is None else _remapped(remap, pix)
    live = inside & (p != 0)[..., None]
    return torch.where(live, rows, -1), t0, t1, p


def _windowed_points(v, x, y, lvl, p, remap, keep, caps, levels, ranges,
                     tile_q):
    """K3's phase A: the query's tile by arithmetic, the window starts of
    (tile, level), the slot read from the whole remap, and a corner
    dropped outside either window."""
    b, n_rows = v.shape[:2]
    geo = msgs_windowed.window_geometry(levels, ranges, tile_q)
    dgeo = msgs_windowed._device_geometry(levels, ranges, tile_q, "cpu")
    w_rows, starts = msgs_windowed.window_starts(geo, dgeo, n_rows, keep, caps)
    n_l = len(levels)
    ok_l = (lvl >= 0) & (lvl < n_l)
    l = lvl.long().clamp(0, n_l - 1)
    hw = torch.tensor(levels)
    st = torch.tensor(geo.level_starts)[l]
    t0, t1, pix, inside = _corners(x, y, st, hw[:, 1][l], hw[:, 0][l])
    tile = torch.from_numpy(msgs_windowed.query_tiles(geo)).view(1, -1, 1, 1)
    starts = starts.long().expand(b, -1, -1, -1)
    bidx = torch.arange(b).view(b, 1, 1, 1)
    p_lo, s_lo = starts[bidx, tile, l, 0], starts[bidx, tile, l, 1]
    wp = torch.tensor(geo.w_pix_levels)[l]
    wv = torch.tensor(w_rows)[l]
    win = lambda lo, at, size: (at - lo[..., None] >= 0) & \
        (at - lo[..., None] < size[..., None])
    if remap is None:
        rows = pix
        keep_c = win(s_lo, pix, wv)
    else:
        rows = _remapped(remap, pix)
        keep_c = win(p_lo, pix, wp) & win(s_lo, rows, wv)
    live = inside & keep_c & (ok_l & (p != 0))[..., None]
    return torch.where(live, rows, -1), t0, t1, p


def _engine(v, rows, t0, t1, p, scale):
    """Phase B: for k = 0, 1, ... the 4 corner rows of the point, gathered
    vector by vector as ``gather_plan`` splits the row, Eq. 4 in float32,
    then p_k S_k added to the running sum; the scale once at the end."""
    b, n_rows, h, dh = v.shape
    plan = gather_plan(dh, v.element_size())
    vf = v.float().reshape(b * n_rows * h, dh)
    bidx = torch.arange(b).view(b, 1, 1)
    hidx = torch.arange(h).view(1, 1, h)
    acc = torch.zeros(rows.shape[:3] + (dh,))
    for k in range(rows.shape[3]):
        n = []
        for c in range(4):
            r = rows[:, :, :, k, c]
            flat = ((bidx * n_rows + r.clamp(min=0)) * h + hidx).reshape(-1)
            row = torch.zeros(flat.shape + (dh,))
            for vec in range(plan.lanes_per_row):
                ch = slice(vec * plan.channels_per_lane,
                           (vec + 1) * plan.channels_per_lane)
                row[:, ch] = vf[flat, ch]
            n.append(row.reshape(r.shape + (dh,)) * (r >= 0)[..., None])
        a0, a1 = t0[:, :, :, k, None], t1[:, :, :, k, None]
        a = ((n[3] - n[2]) - n[1]) + n[0]
        s = (n[0] + (n[2] - n[0]) * a0) + ((n[1] - n[0]) + a * a0) * a1
        acc = acc + p[:, :, :, k, None] * s
    if scale is not None:
        acc = acc * scale.reshape(b, 1, h, dh)
    return acc


def _tol(scale):
    if scale is None:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-5 * 127 * float(np.max(scale)))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("entry,layout,kind", k1_cases.K1_CASES)
def test_engine_mirror_k1_matches_pallas(entry, layout, kind):
    v, scale, remap, pts = k1_cases._k1_case(entry, layout, kind)
    rows, t0, t1, p = _fused_points(*map(_t, pts), _t(remap))
    got = _engine(_t(v), rows, t0, t1, p, _t(scale))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(k1_cases._k1_reference()[entry, layout, kind]),
        **_tol(scale))


@pytest.mark.parametrize("kind,layout,hp", k3_cases.K3_CASES)
def test_engine_mirror_k3_matches_pallas(kind, layout, hp):
    d = k3_cases._k3_case(kind, layout, hp)
    v = _t(d["v"])
    rows, t0, t1, p = _windowed_points(
        v, _t(d["x"]), _t(d["y"]), _t(d["lvl"]), _t(d["p"]), _t(d["remap"]),
        _t(d["keep"]), d["caps"], k3_cases.TOY, k3_cases.K3_RANGES,
        k3_cases.K3_TILE)
    got = _engine(v, rows, t0, t1, p, _t(d["scale"]))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(k3_cases._k3_reference()[kind, layout, hp]),
        **_tol(d["scale"]))
    # the same mirror without the windows is K1's, and differs: the
    # windows decide
    b, n_in, h, k = d["x"].shape
    st = np.asarray(msgs_windowed.window_geometry(
        k3_cases.TOY, k3_cases.K3_RANGES, k3_cases.K3_TILE).level_starts,
        np.int32)[d["lvl"]]
    wl = np.asarray([w for _, w in k3_cases.TOY], np.int32)[d["lvl"]]
    hl = np.asarray([a for a, _ in k3_cases.TOY], np.int32)[d["lvl"]]
    k1 = _engine(v, *_fused_points(_t(d["x"]), _t(d["y"]), _t(st), _t(wl),
                                   _t(hl), _t(d["p"]), _t(d["remap"])),
                 _t(d["scale"]))
    assert float(((k1 - got).abs().amax(-1) > 1e-3).float().mean()) > 0.01
