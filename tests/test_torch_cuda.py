"""The port's CUDA kernels on the card against their plain versions, and
K2's backward kernel against its closed-form plain version.

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
