"""The port's CUDA kernels on the card against their plain versions, and
K2's backward kernel against its closed-form plain version. K4 and K5
state their tolerances in their own docstrings.

Marked ``gpu``: without a CUDA device these tests skip (the decision is
made inside each test, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: float32 rtol = atol = 1e-5; int8
1e-5 * 127 * max scale; the backward's table and scale gradients, which
the kernels sum in another order than the plain version, rtol 1e-5 and
atol 1e-5 of their largest entry. Two backward calls on the same operands
must agree bit for bit."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(device, b=2, nq=37, h=4, k=8, dh=32, n_rows=120, int8=False):
    g = torch.Generator().manual_seed(0)
    levels = ((8, 10), (4, 5))
    lvl = torch.randint(0, 2, (b, nq, h, k), generator=g)
    wl = torch.tensor([10, 5], dtype=torch.int32)[lvl]
    hl = torch.tensor([8, 4], dtype=torch.int32)[lvl]
    st = torch.tensor([0, 80], dtype=torch.int32)[lvl]
    x = torch.rand((b, nq, h, k), generator=g) * (wl + 2) - 1
    y = torch.rand((b, nq, h, k), generator=g) * (hl + 2) - 1
    p = torch.softmax(torch.randn((b, nq, h, k), generator=g), -1)
    n_pix = sum(a * c for a, c in levels)
    remap = torch.randint(0, n_rows, (b, n_pix), generator=g).to(torch.int32)
    if int8:
        v = torch.randint(-127, 128, (b, n_rows, h, dh), generator=g).to(torch.int8)
        scale = torch.rand((b, 1, h, dh), generator=g) * 0.01 + 0.001
    else:
        v, scale = torch.randn((b, n_rows, h, dh), generator=g), None
    to = lambda t: None if t is None else t.contiguous().to(device)
    return to(v), [to(t) for t in (x, y, st, wl, hl, p)], to(remap), to(scale)


@pytest.mark.parametrize("int8", [False, True])
def test_msgs_fused_kernel_matches_plain(cuda, int8):
    from repro_torch.kernels import msgs_fused
    v, pts, remap, scale = _operands(cuda, int8=int8)
    before = msgs_fused.LAUNCHES
    got = msgs_fused.msgs_fused(v, *pts, remap=remap, scale=scale)
    torch.cuda.synchronize()
    assert msgs_fused.LAUNCHES == before + 1
    want = msgs_fused.msgs_fused_plain(v, *pts, remap=remap, scale=scale)
    atol = 1e-5 if scale is None else 1e-5 * 127 * float(scale.max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("int8", [False, True])
def test_msgs_decode_kernel_matches_plain(cuda, int8):
    from repro_torch.kernels import msgs_decode
    v, pts, remap, scale = _operands(cuda, int8=int8)
    staged = msgs_decode.stage_decode_table(v, remap, head_pack=4, scale=scale)
    layered = [torch.stack([t, t.flip(1)], 1).contiguous() for t in pts]
    before = msgs_decode.LAUNCHES
    got = msgs_decode.msgs_decode_layers(staged, *layered)
    torch.cuda.synchronize()
    assert msgs_decode.LAUNCHES == before + 1
    want = msgs_decode.msgs_decode_plain(staged.v, *layered, staged.remap,
                                         staged.scale, head_pack=4, dh=32)
    atol = 1e-5 if scale is None else 1e-5 * 127 * float(scale.max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("int8", [False, True])
def test_msgs_windowed_kernel_matches_plain(cuda, int8, layout):
    """K3 on a ragged pyramid (tile 8) with points up to three range
    bounds from their reference, so that the windows drop corners."""
    from repro_torch.kernels import msgs_windowed
    levels, ranges, hp = ((6, 7), (3, 4), (2, 2)), (1.5, 1.0, 0.5), 2
    g = torch.Generator().manual_seed(1)
    b, h, k, dh = 2, 4, 6, 32
    n_in = sum(a * c for a, c in levels)
    lvl = torch.randint(0, 3, (b, n_in, h, k), generator=g, dtype=torch.int32)
    wl = torch.tensor([w for _, w in levels])[lvl.long()]
    hl = torch.tensor([a for a, _ in levels])[lvl.long()]
    x = torch.rand((b, n_in, h, k), generator=g) * (wl + 2) - 1
    y = torch.rand((b, n_in, h, k), generator=g) * (hl + 2) - 1
    p = torch.softmax(torch.randn((b, n_in, h, k), generator=g), -1)
    remap = keep = caps = None
    n_rows = n_in
    if layout == "compact":
        caps = (25, 7, 2)
        starts = (0, 42, 54)
        keep = torch.cat([torch.sort(torch.randperm(a * c, generator=g)[:cap]
                                     )[0] + s for (a, c), cap, s
                          in zip(levels, caps, starts)]).expand(b, -1)
        n_rows = sum(caps) + 1
        remap = torch.full((b, n_in), n_rows - 1, dtype=torch.int64)
        remap.scatter_(1, keep, torch.arange(n_rows - 1).expand(b, -1))
        keep, remap = keep.to(torch.int32), remap.to(torch.int32)
    if int8:
        v = torch.randint(-127, 128, (b, n_rows, h, dh), generator=g).to(torch.int8)
        scale = torch.rand((b, h // hp, hp, dh), generator=g) * 0.01 + 0.001
    else:
        v, scale = torch.randn((b, n_rows, h, dh), generator=g), None
    if layout == "compact":
        v[:, -1] = 0
    to = lambda t: None if t is None else t.contiguous().to(cuda)
    args = [to(t) for t in (v, x, y, lvl, p)]
    kw = dict(remap=to(remap), keep_idx=to(keep), scale=to(scale),
              level_shapes=levels, ranges=ranges, tile_q=8, head_pack=hp,
              caps=caps)
    before = msgs_windowed.LAUNCHES
    got = msgs_windowed.msgs_windowed_msp(*args, **kw)
    torch.cuda.synchronize()
    assert msgs_windowed.LAUNCHES == before + 1
    want = msgs_windowed.msgs_windowed_msp_plain(*args, **kw)
    atol = 1e-5 if scale is None else 1e-5 * 127 * float(scale.max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def _gather_tolerance(got, scale):
    if got.dtype == torch.bfloat16:
        return dict(rtol=2 ** -7, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-5 if scale is None
                else 1e-5 * 127 * float(scale.max()))


def _table(g, shape, dtype, device, offset=0):
    """A random table of ``dtype`` on ``device``; with ``offset`` it is
    contiguous but starts ``offset`` elements into its storage."""
    if dtype == "int8":
        v = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
    else:
        v = torch.randn(shape, generator=g).to(getattr(torch, dtype))
    buf = torch.empty(v.numel() + offset, dtype=v.dtype, device=device)
    out = buf[offset:].view(shape)
    out.copy_(v)
    return out


def _level_points(g, b, levels, h, k, device, spread=None):
    """(x, y, level, probs) of raster queries over ``levels``: each point
    on a random level, around its query's reference point (``spread``
    range bounds per level) or anywhere on the level; some p are 0."""
    refs = torch.cat([torch.stack(torch.meshgrid(
        (torch.arange(a) + 0.5) / a, (torch.arange(c) + 0.5) / c,
        indexing="ij")[::-1], -1).reshape(-1, 2) for a, c in levels])
    shape = (b, refs.shape[0], h, k)
    lvl = torch.randint(0, len(levels), shape, generator=g)
    wl = torch.tensor([c for _, c in levels], dtype=torch.float32)[lvl]
    hl = torch.tensor([a for a, _ in levels], dtype=torch.float32)[lvl]
    if spread is None:
        x = torch.rand(shape, generator=g) * (wl + 2) - 1
        y = torch.rand(shape, generator=g) * (hl + 2) - 1
    else:
        bound = torch.tensor(spread)[lvl]
        x = refs[:, 0].view(1, -1, 1, 1) * wl - 0.5 + \
            (torch.rand(shape, generator=g) * 6 - 3) * bound
        y = refs[:, 1].view(1, -1, 1, 1) * hl - 0.5 + \
            (torch.rand(shape, generator=g) * 6 - 3) * bound
    p = torch.softmax(torch.randn(shape, generator=g), -1)
    p = torch.where(torch.rand(shape, generator=g) < 0.1, 0.0, p)
    return [t.contiguous().to(device) for t in (x, y, lvl.to(torch.int32), p)]


def _fused_call(g, levels, b, h, k, dh, dtype, device, compact, offset=0):
    from repro_torch.kernels.msgs_fused import msgs_fused, msgs_fused_plain
    from repro_torch.msda.sampling import level_meta
    x, y, lvl, p = _level_points(g, b, levels, h, k, device)
    starts, ws, hs, _ = level_meta(levels, device=device)
    st, wl, hl = (t[lvl.long()].contiguous() for t in (starts, ws, hs))
    n_pix = sum(a * c for a, c in levels)
    n_rows = (n_pix * 3) // 5 + 1 if compact else n_pix
    v = _table(g, (b, n_rows, h, dh), dtype, device, offset)
    remap = None
    if compact:
        v[:, -1] = 0
        remap = torch.randint(0, n_rows, (b, n_pix), generator=g)
        remap = remap.to(torch.int32).to(device)
    scale = None
    if dtype == "int8":
        scale = (torch.rand((b, 1, h, dh), generator=g) * 0.01 + 0.001).to(device)
    args, kw = (v, x, y, st, wl, hl, p), dict(remap=remap, scale=scale)
    return msgs_fused(*args, **kw), msgs_fused_plain(*args, **kw), scale


@pytest.mark.parametrize("dh,offset", [(12, 0), (125, 0), (32, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_msgs_fused_gather_plan_widths(cuda, dtype, dh, offset):
    """K1 on rows the 16 B vector does not fit: Dh 12 (rows of 48, 24 and
    12 B: 3 lanes of 16, 8 and 4 B), Dh 125 (odd rows: 4 chunks of narrow
    vectors per row), and a table one element off its 16 B alignment."""
    from repro_torch.kernels import msgs_fused
    v_item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    plan = msgs_fused.gather_plan(dh, v_item, 16 if offset == 0 else v_item)
    assert plan.vec_bytes < 16 or plan.lanes_per_row % 2 == 1
    g = torch.Generator().manual_seed(3)
    before = msgs_fused.LAUNCHES
    got, want, scale = _fused_call(g, ((8, 10), (4, 5)), 2, 4, 6, dh, dtype,
                                   cuda, compact=True, offset=offset)
    torch.cuda.synchronize()
    assert msgs_fused.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, **_gather_tolerance(got, scale))


def test_msgs_fused_kernel_at_the_512px_path_shape(cuda):
    """K1 at the 512 px encoder block's shape: points (2, 21760, 8, 4), a
    compact float32 table (2, 13057, 8, 32)."""
    g = torch.Generator().manual_seed(4)
    levels = tuple((512 // s, 512 // s) for s in (4, 8, 16, 32))
    got, want, _ = _fused_call(g, levels, 2, 8, 4, 32, "float32", cuda,
                               compact=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _windowed_call(g, levels, ranges, tile_q, b, h, k, dh, dtype, hp,
                   device, compact):
    from repro_torch.core.fwp import level_capacities, level_starts
    from repro_torch.kernels import msgs_windowed
    x, y, lvl, p = _level_points(g, b, levels, h, k, device, spread=ranges)
    starts, n_in = level_starts(levels)
    remap = keep = caps = None
    n_rows = n_in
    if compact:
        caps = tuple(level_capacities(levels, 0.6))
        keep = torch.cat([torch.sort(torch.randperm(a * c, generator=g)[:cap])[0]
                          + int(s) for (a, c), cap, s in zip(levels, caps, starts)])
        keep = keep.expand(b, -1).contiguous()
        n_rows = sum(caps) + 1
        remap = torch.full((b, n_in), n_rows - 1, dtype=torch.int64)
        remap.scatter_(1, keep, torch.arange(n_rows - 1).expand(b, -1).contiguous())
        keep, remap = (t.to(torch.int32).to(device) for t in (keep, remap))
    v = _table(g, (b, n_rows, h, dh), dtype, device)
    if compact:
        v[:, -1] = 0
    scale = None
    if dtype == "int8":
        scale = (torch.rand((b, h // hp, hp, dh), generator=g) * 0.01
                 + 0.001).to(device)
    args = (v, x, y, lvl, p)
    kw = dict(remap=remap, keep_idx=keep, scale=scale, level_shapes=levels,
              ranges=ranges, tile_q=tile_q, head_pack=hp, caps=caps)
    before = msgs_windowed.LAUNCHES
    got = msgs_windowed.msgs_windowed_msp(*args, **kw)
    torch.cuda.synchronize()
    assert msgs_windowed.LAUNCHES == before + 1
    return got, msgs_windowed.msgs_windowed_msp_plain(*args, **kw), scale


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_msgs_windowed_kernel_dh12(cuda, dtype, layout):
    """K3 with Dh 12 (rows of 48, 24 and 12 B) on a ragged pyramid whose
    windows drop corners."""
    g = torch.Generator().manual_seed(5)
    got, want, scale = _windowed_call(
        g, ((13, 17), (7, 9), (4, 5), (2, 3)), (3.5, 2.5, 1.5, 1.0), 16, 2, 4,
        4, 12, dtype, 2, cuda, layout == "compact")
    torch.testing.assert_close(got, want, **_gather_tolerance(got, scale))


def test_msgs_windowed_kernel_at_the_1024px_path_shape(cuda):
    """K3 at the 1024 px encoder block's shape: points (2, 87040, 8, 4), a
    compact int8 table of 8 heads x Dh 32, head groups of 4, tile 128."""
    g = torch.Generator().manual_seed(6)
    levels = tuple((1024 // s, 1024 // s) for s in (4, 8, 16, 32))
    got, want, scale = _windowed_call(g, levels, (16.0, 12.0, 8.0, 4.0), 128,
                                      2, 8, 4, 32, "int8", 4, cuda, True)
    torch.testing.assert_close(got, want, **_gather_tolerance(got, scale))


@pytest.mark.parametrize("int8", [False, True])
def test_msgs_decode_backward_kernel_matches_plain(cuda, int8):
    from repro_torch.kernels import msgs_decode
    v, pts, remap, scale = _operands(cuda, int8=int8)
    staged = msgs_decode.stage_decode_table(v, remap, head_pack=4, scale=scale)
    layered = [torch.stack([t, t.flip(1)], 1).contiguous() for t in pts]
    gen = torch.Generator().manual_seed(2)
    g_out = torch.randn(layered[0].shape[:4] + (32,), generator=gen).to(cuda)
    before = msgs_decode.LAUNCHES_BWD
    got = msgs_decode.msgs_decode_backward(staged, *layered, g_out)
    torch.cuda.synchronize()
    assert msgs_decode.LAUNCHES_BWD == before + 1
    want = msgs_decode.msgs_decode_backward_plain(
        staged.v, *layered, g_out, staged.remap, staged.scale, head_pack=4,
        dh=32)
    assert (got[0] is None) == int8 and (got[4] is None) == (not int8)
    atol = 1e-5 if scale is None else 1e-5 * 127 * float(scale.max())
    for i, (a, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        tol = 1e-5 * float(w.abs().max()) if i in (0, 4) else atol
        torch.testing.assert_close(a, w, rtol=1e-5, atol=tol)


def test_cuda_decode_output_carries_a_gradient(cuda):
    """Under autograd K2's output has a grad_fn, and backward launches the
    backward kernel; the forward-only K1 refuses."""
    from repro_torch.kernels import msgs_decode, msgs_fused
    v, pts, remap, _ = _operands(cuda)
    v.requires_grad_()
    staged = msgs_decode.stage_decode_table(v, remap, head_pack=4)
    before = msgs_decode.LAUNCHES_BWD
    out = msgs_decode.msgs_decode(staged, *pts)
    assert out.grad_fn is not None
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert msgs_decode.LAUNCHES_BWD == before + 1
    assert float(v.grad.abs().sum()) > 0
    with pytest.raises(RuntimeError, match="torch_gather"):
        msgs_fused.msgs_fused(v, *pts, remap=remap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_matches_plain(cuda, dtype):
    """K5 with Hkv not dividing Hq (6 over 4), W 100 padded at chunk 16,
    one row with no valid slot. float32 1e-5; bf16 rtol 2^-7 (one bf16
    rounding step of the output)."""
    from repro_torch.kernels import flash_decode
    g = torch.Generator().manual_seed(3)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g).to(tdt).to(cuda)
               for s in ((3, 6, 64), (3, 100, 4, 64), (3, 100, 4, 64)))
    valid = torch.rand((3, 100), generator=g) < 0.6
    valid[0] = False
    valid = valid.to(cuda)
    before = flash_decode.LAUNCHES
    got = flash_decode.flash_decode(q, k, v, valid, chunk=16)
    torch.cuda.synchronize()
    assert flash_decode.LAUNCHES == before + 1
    want = flash_decode.flash_decode_plain(q, k, v, valid, chunk=16)
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16", "int8"])
def test_matmul_kernel_matches_plain(cuda, w_dtype):
    """K4 on ragged (70, 257) x (257, 65). atol 2^-20 of the largest
    absolute sum |x| @ |w| (the kernel and the plain version sum K in
    other orders); bf16 output rtol 2^-7 (one bf16 rounding step)."""
    from repro_torch.kernels import matmul
    g = torch.Generator().manual_seed(4)
    x = torch.randn((70, 257), generator=g)
    w = torch.randn((257, 65), generator=g)
    scale = None
    if w_dtype == "int8":
        scale = (w.abs().amax(0, keepdim=True) / 127).to(cuda)
        w = (w / scale.cpu()).round().to(torch.int8)
    elif w_dtype == "bfloat16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    x, w = x.to(cuda), w.to(cuda)
    before = matmul.LAUNCHES
    got = matmul.matmul(x, w, scale)
    torch.cuda.synchronize()
    assert matmul.LAUNCHES == before + 1
    want = matmul.matmul_plain(x, w, scale)
    atol = 2 ** -20 * float((x.float().abs() @ matmul.dequantized(w, scale).abs()).max())
    rtol = 2 ** -7 if x.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _matmul_tolerance(x, w, scale):
    from repro_torch.kernels import matmul
    big = float((x.float().abs() @ matmul.dequantized(w, scale).abs()).max())
    return {"rtol": 2 ** -7 if x.dtype == torch.bfloat16 else 0.0,
            "atol": 2 ** -20 * big}


@pytest.mark.parametrize("m,k,n", [(96, 256, 192), (1, 1024, 512), (65, 512, 384),
                                   (128, 3000, 256), (300, 128, 1040)])
@pytest.mark.parametrize("w_dtype", ["bfloat16", "int8"])
def test_matmul_wgmma_route_matches_plain(cuda, m, k, n, w_dtype):
    """K4's wgmma route on bf16 x: a tile edge in M (1, 65, 300), K 3000
    (not a multiple of the K step), N 1040 (not a multiple of the tile),
    and a split K (M 1). Tolerance as in test_matmul_kernel_matches_plain:
    atol 2^-20 of max(|x| @ |w|) and bf16 rtol 2^-7; an int8 w's scale
    multiplies the float32 sum instead of each code, which changes only
    the float32 rounding order."""
    from repro_torch.kernels import matmul
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g)
    scale = None
    if w_dtype == "int8":
        scale = w.abs().amax(0, keepdim=True) / 127
        w = (w / scale).round().clamp(-127, 127).to(torch.int8)
        scale = scale.to(cuda)
    else:
        w = w.to(torch.bfloat16)
    x, w = x.to(cuda), w.to(cuda)
    assert matmul.matmul_route(x, w, scale) == "wgmma"
    before = dict(matmul.LAUNCHES_BY_ROUTE)
    got = matmul.matmul(x, w, scale)
    torch.cuda.synchronize()
    assert matmul.LAUNCHES_BY_ROUTE["wgmma"] == before["wgmma"] + 1
    want = matmul.matmul_plain(x, w, scale)
    torch.testing.assert_close(got, want, **_matmul_tolerance(x, w, scale))


def test_matmul_ragged_bf16_takes_the_simt_route(cuda):
    """(70, 257) x (257, 65) in bf16: K and N not multiples of 8, so TMA
    cannot describe it and the SIMT kernel runs."""
    from repro_torch.kernels import matmul
    g = torch.Generator().manual_seed(5)
    x = torch.randn((70, 257), generator=g).to(torch.bfloat16).to(cuda)
    w = torch.randn((257, 65), generator=g).to(torch.bfloat16).to(cuda)
    assert matmul.matmul_route(x, w) == "simt"
    before = matmul.LAUNCHES_BY_ROUTE["simt"]
    got = matmul.matmul(x, w)
    torch.cuda.synchronize()
    assert matmul.LAUNCHES_BY_ROUTE["simt"] == before + 1
    torch.testing.assert_close(got, matmul.matmul_plain(x, w),
                               **_matmul_tolerance(x, w, None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_empty_split_and_empty_row(cuda, dtype):
    """K5 with W 1000 in splits of 64 (a ragged last split): row 0 has no
    valid slot, row 1 valid slots only outside its first splits, row 2 a
    single valid slot at W - 1. float32 1e-5; bf16 rtol 2^-7."""
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.msgs_fused import sm_count
    g = torch.Generator().manual_seed(6)
    tdt = getattr(torch, dtype)
    b, hq, hkv, dh, w = 3, 8, 2, 128, 1000
    q = torch.randn((b, hq, dh), generator=g).to(tdt).to(cuda)
    k, v = (torch.randn((b, w, hkv, dh), generator=g).to(tdt).to(cuda)
            for _ in range(2))
    valid = torch.zeros((b, w), dtype=torch.bool)
    valid[1, 300:700] = torch.rand(400, generator=g) < 0.5
    valid[2, w - 1] = True
    valid = valid.to(cuda)
    assert flash_decode.decode_splits(b, hkv, 1, w, sm_count(valid.device))[0] == 64
    got = flash_decode.flash_decode(q, k, v, valid, chunk=512)
    want = flash_decode.flash_decode_plain(q, k, v, valid, chunk=512)
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5)


def _decode_call(g, levels, b, n_layers, nq, h, k, dh, dtype, hp, device,
                 compact, offset=0):
    """A staged table (B, H/hp, N_rows, hp * dh) of ``dtype``, ``offset``
    elements into its storage, and stacked points (B, L, Nq, H, K) that
    spill past every level edge; some p are 0."""
    from repro_torch.kernels import msgs_decode
    from repro_torch.msda.sampling import level_meta
    shape = (b, n_layers, nq, h, k)
    lvl = torch.randint(0, len(levels), shape, generator=g)
    starts, ws, hs, _ = level_meta(levels, device="cpu")
    st, wl, hl = (t[lvl].to(torch.int32) for t in (starts, ws, hs))
    x = torch.rand(shape, generator=g) * (wl + 2).float() - 1
    y = torch.rand(shape, generator=g) * (hl + 2).float() - 1
    p = torch.softmax(torch.randn(shape, generator=g), -1)
    p = torch.where(torch.rand(shape, generator=g) < 0.1, 0.0, p)
    n_pix = sum(a * c for a, c in levels)
    n_rows = (n_pix * 3) // 5 + 1 if compact else n_pix
    v = _table(g, (b, h // hp, n_rows, hp * dh), dtype, device, offset)
    remap = scale = None
    if compact:
        v[:, :, -1] = 0
        remap = torch.randint(0, n_rows, (b, n_pix), generator=g)
        remap = remap.to(torch.int32).to(device)
    if dtype == "int8":
        scale = (torch.rand((b, h // hp, hp * dh), generator=g) * 0.01
                 + 0.001).to(device)
    staged = msgs_decode.DecodeStagedTable(v=v, remap=remap, n_rows=n_rows,
                                           head_pack=hp, dh=dh, table_bytes=0,
                                           scale=scale)
    return staged, [t.contiguous().to(device) for t in (x, y, st, wl, hl, p)]


def _decode_plain(staged, pts):
    from repro_torch.kernels import msgs_decode
    return msgs_decode.msgs_decode_plain(
        staged.v, *pts, staged.remap, staged.scale,
        head_pack=staged.head_pack, dh=staged.dh)


def test_msgs_decode_kernel_at_the_512px_path_shape(cuda):
    """K2 at the 512 px decoder layer's shape: points (2, 300, 8, 4), a
    compact float32 staged table (2, 2, 13057, 128)."""
    from repro_torch.kernels import msgs_decode
    g = torch.Generator().manual_seed(7)
    levels = tuple((512 // s, 512 // s) for s in (4, 8, 16, 32))
    staged, pts = _decode_call(g, levels, 2, 1, 300, 8, 4, 32, "float32", 4,
                               cuda, True)
    assert tuple(staged.v.shape) == (2, 2, 13057, 128)
    before = msgs_decode.LAUNCHES
    got = msgs_decode.msgs_decode(staged, *(t[:, 0] for t in pts))
    torch.cuda.synchronize()
    assert msgs_decode.LAUNCHES == before + 1
    torch.testing.assert_close(got, _decode_plain(staged, pts)[:, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hp", [1, 4])
@pytest.mark.parametrize("dh,offset", [(12, 0), (32, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_msgs_decode_kernel_gather_plan_widths(cuda, dtype, dh, offset, hp):
    """K2 on rows the 16 B vector does not fit: Dh 12 (rows of 48, 24 and
    12 B) and a staged table one element off its 16 B alignment, with
    head groups of 1 and 4 and L = 3 stacked layers."""
    from repro_torch.kernels import msgs_decode
    g = torch.Generator().manual_seed(8)
    staged, pts = _decode_call(g, ((13, 17), (7, 9), (4, 5), (2, 3)), 2, 3,
                               19, 4, 4, dh, dtype, hp, cuda, True, offset)
    plan = msgs_decode.table_plan(staged.v, 3 * 19 * 4, hp, dh)
    assert plan.vec_bytes < 16 or plan.lanes_per_row % 2 == 1
    got = msgs_decode.msgs_decode_layers(staged, *pts)
    torch.testing.assert_close(got, _decode_plain(staged, pts),
                               **_gather_tolerance(got, staged.scale))


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_msgs_decode_backward_is_bitwise_repeatable(cuda, dtype, compact):
    """Two backward calls on the same operands give bitwise-equal d_vp,
    d_x, d_y, d_probs and d_scale, and agree with the plain version; a
    bf16 table gets a bf16 d_vp."""
    from repro_torch.kernels import msgs_decode
    g = torch.Generator().manual_seed(9)
    staged, pts = _decode_call(g, ((16, 20), (8, 10), (4, 5), (2, 3)), 2, 3,
                               30, 8, 4, 32, dtype, 4, cuda, compact)
    g_out = torch.randn(pts[0].shape[:4] + (32,), generator=g).to(cuda)
    first = msgs_decode.msgs_decode_backward(staged, *pts, g_out)
    again = msgs_decode.msgs_decode_backward(staged, *pts, g_out)
    torch.cuda.synchronize()
    assert (first[0] is None) == (dtype == "int8")
    assert (first[4] is None) == (dtype != "int8")
    for a, b in zip(first, again):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    if dtype != "int8":
        assert first[0].dtype == staged.v.dtype
    want = msgs_decode.msgs_decode_backward_plain(
        staged.v, *pts, g_out, staged.remap, staged.scale, head_pack=4, dh=32)
    atol = 1e-5 if staged.scale is None else \
        1e-5 * 127 * float(staged.scale.max())
    for i, (a, w) in enumerate(zip(first, want)):
        if w is None:
            continue
        if i in (0, 4):
            tol = dict(rtol=2 ** -7 if a.dtype == torch.bfloat16 else 1e-5,
                       atol=1e-5 * float(w.float().abs().max()))
        else:
            tol = dict(rtol=1e-5, atol=atol)
        torch.testing.assert_close(a, w, **tol)


# --------------------------------------------------------------------------
# serving through CUDA graphs (one per detector bucket, one per LM decode
# shape): replays agree with the eager forward, pipelined batches do not
# alias the graph's static outputs, and a capture that meets a host sync
# raises instead of serving eagerly
# --------------------------------------------------------------------------

def _capture_detector():
    from repro_torch.core.detector import DetectorConfig, init_detector
    from repro_torch.core.encoder import EncoderConfig
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig
    from repro_torch.msda.decoder import MSDADecoderConfig
    attn = MSDeformAttnConfig(d_model=64, n_heads=4)
    cfg = DetectorConfig(encoder=EncoderConfig(attn=attn, n_blocks=2, d_ffn=128),
                         img_size=64, backbone_width=16,
                         decoder=MSDADecoderConfig(n_layers=2, n_queries=30,
                                                   d_ffn=128))
    return cfg, init_detector(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def _capture_images(n, size=64, seed=4):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (3, size, size)).astype(np.float32)
            for _ in range(n)]


def test_captured_bucket_forward_matches_eager(cuda):
    """One replay of the bucket's graph against the engine's eager
    forward on the same input: the same kernels on the same operands,
    held to 1e-5."""
    import numpy as np
    from repro_torch.serve import DetrServeEngine
    cfg, params = _capture_detector()
    with DetrServeEngine(cfg, params, max_batch=2, backend="auto",
                         device=cuda) as engine:
        assert engine.compile_count == 1
        assert all(b.is_pinned() for b in engine._graphs[64].pinned)
        imgs = _capture_images(2)
        cls, boxes, ready = engine.dispatch(imgs, 64)
        ready.synchronize()
        want = engine.forward(torch.from_numpy(np.stack(imgs)).to(cuda), 64)
        for got, w in zip((cls, boxes), want[:2]):
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


def test_pipelined_batches_do_not_alias_the_static_outputs(cuda):
    """Three batches of different images dispatched back to back with the
    postproc worker on: each request's outputs equal the eager forward of
    its own batch (a replay rewriting an earlier batch's outputs, or a
    pinned buffer refilled under its copy, would give another batch's)."""
    import numpy as np
    from repro_torch.serve import DetrRequest, DetrServeEngine
    cfg, params = _capture_detector()
    imgs = _capture_images(6)
    with DetrServeEngine(cfg, params, max_batch=2, backend="auto",
                         device=cuda) as engine:
        reqs = [DetrRequest(rid=i, image=im) for i, im in enumerate(imgs)]
        for r in reqs:
            assert engine.submit(r)
        for _ in range(3):
            assert engine.step() == 2
        engine.drain()
        for k in range(3):
            x = torch.from_numpy(np.stack(imgs[2 * k:2 * k + 2])).to(cuda)
            cls, boxes, _ = engine.forward(x, 64)
            probs = torch.softmax(cls, -1).cpu().numpy()
            for j in range(2):
                r = reqs[2 * k + j]
                np.testing.assert_allclose(r.boxes, boxes[j].cpu().numpy(),
                                           rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(r.cls_probs, probs[j],
                                           rtol=1e-5, atol=1e-6)
        assert engine.compile_count == 1


def test_captured_lm_decode_step_matches_eager(cuda):
    """The LM engine's replayed decode step against the eager step on a
    copy of the same state (float32 toy model, 1e-4)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_decode
    from repro_torch.models.decoder import decode_step, init_decoder
    from repro_torch.serve.lm import Request, ServeConfig, ServeEngine
    cfg = dataclasses.replace(get_smoke_config("minitron-4b"),
                              dtype=torch.float32)
    params = init_decoder(cfg, torch.Generator().manual_seed(0), device=cuda)
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=2, cache_len=64),
                      device=cuda)
    assert eng.compile_count == 1 and eng._graph is not None
    g = torch.Generator().manual_seed(3)
    for i, n in enumerate((5, 9)):
        eng.submit(Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (n,), generator=g).numpy(), max_new_tokens=4))
    eng.step()
    cache = copy.deepcopy(eng.cache)
    tok, pos = eng.last_tok.clone(), eng.pos.clone()
    with torch.inference_mode():
        got = eng.decode_logits()
        want, _ = decode_step(eng.params, cfg, cache, tok, pos)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    launches = flash_decode.LAUNCHES
    eng.run_until_drained()
    assert eng.compile_count == 1
    assert flash_decode.LAUNCHES == launches      # replays call no wrapper


def test_host_sync_inside_a_captured_forward_raises(cuda, monkeypatch):
    """A forward that syncs with the host cannot be captured: building the
    engine raises, and no engine serves it eagerly."""
    from repro_torch.core import nn
    from repro_torch.serve import DetrServeEngine
    cfg, params = _capture_detector()
    orig = nn.inverse_sigmoid

    def syncing(x, eps=1e-5):
        float(x.sum())                       # a device-to-host read
        return orig(x, eps)
    monkeypatch.setattr(nn, "inverse_sigmoid", syncing)
    with pytest.raises(RuntimeError):
        DetrServeEngine(cfg, params, max_batch=2, backend="auto", device=cuda)
    monkeypatch.undo()
    torch.cuda.synchronize()
