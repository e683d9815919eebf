"""The port's CUDA kernels on the card against their plain versions, and
K2's backward kernel against its closed-form plain version. K4 and K5
state their tolerances in their own docstrings.

Marked ``gpu``: without a CUDA device these tests skip (the decision is
made inside each test, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: float32 rtol = atol = 1e-5; int8
1e-5 * 127 * max scale; the backward's table and scale gradients, which
the kernel sums with float32 atomics in an order that changes from run to
run, rtol 1e-5 and atol 1e-5 of their largest entry."""
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
