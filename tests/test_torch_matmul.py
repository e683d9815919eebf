"""Kernel K4 (tiled matmul, int8-weight variant) of the PyTorch port: its
plain PyTorch version against the reference's Pallas kernel
``matmul_pallas``, run as the JAX tests run it on the CPU
(``repro.kernels.ops.matmul`` in interpret mode).

Tolerances: float32 rtol = atol = 1e-5 (both sides sum the same bk-wide
float32 partial products, each in its own order); bf16 output rtol 2^-7
(one bf16 rounding step of the output, which the two float32 sums may
round to neighbouring values) and atol 1e-5; int8 rtol = atol = 1e-5 (x
and the dequantized w meet in the same float32 product on both sides).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.matmul import matmul_plain  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": {"rtol": 1e-5, "atol": 1e-5},
       "bfloat16": {"rtol": 2 ** -7, "atol": 1e-5}}


def _pair(rng, m, k, n):
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(70, 90, 50), (128, 128, 128), (33, 257, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas_sweep(m, k, n, dtype):
    """The reference's sweep at bm = bn = bk = 32 (ragged M, K, N)."""
    x, w = _pair(np.random.default_rng(m), m, k, n)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = ops.matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                     bm=32, bn=32, bk=32)
    assert got.dtype == tdt and got.shape == (m, n)
    want = ref_ops.matmul(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                          bm=32, bn=32, bk=32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_matmul_int8_dequant_matches_pallas(x_dtype):
    """int8 codes with a per-column (1, N) float32 scale, dequantized in
    the kernel (bm 32, bn 16, bk 32, as the reference's test); the output
    takes x's dtype."""
    x, w = _pair(np.random.default_rng(9), 64, 96, 48)
    s = (np.abs(w).max(0, keepdims=True) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / s), -128, 127).astype(np.int8)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[x_dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[x_dtype]
    got = ops.matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
                     torch.from_numpy(s), bm=32, bn=16, bk=32)
    want = ref_ops.matmul(jnp.asarray(x).astype(jdt), jnp.asarray(wq),
                          jnp.asarray(s), bm=32, bn=16, bk=32)
    assert got.dtype == tdt
    tol = {"rtol": 1e-5, "atol": 1e-5} if x_dtype == "float32" else TOL[x_dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)
    # and the quantized product approximates the float32 one
    np.testing.assert_allclose(got.float().numpy(), x @ w, rtol=0.2, atol=0.2)


def test_matmul_tiles_change_only_the_summation_order():
    """Other tiles sum K in other steps: the results differ by float32
    roundoff only, held to 1e-6 of the largest absolute sum |x| @ |w|."""
    x, w = (torch.from_numpy(a) for a in _pair(np.random.default_rng(3),
                                                 50, 300, 40))
    atol = 1e-6 * float((x.abs() @ w.abs()).max())
    a = matmul_plain(x, w, bm=16, bn=8, bk=7)
    torch.testing.assert_close(a, matmul_plain(x, w), rtol=0, atol=atol)
    torch.testing.assert_close(a, x @ w, rtol=0, atol=atol)
    assert torch.equal(matmul_plain(x, w, bk=300), matmul_plain(x, w, bk=4096))
