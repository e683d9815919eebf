"""The port's CUDA kernels on the card against their plain versions.

Marked ``gpu``: without a CUDA device these tests skip (the decision is
made inside each test, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: float32 rtol = atol = 1e-5; int8
1e-5 * 127 * max scale."""
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
