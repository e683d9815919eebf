"""Kernel K5 (one-token GQA flash-decode) of the PyTorch port: its plain
PyTorch version against the reference's Pallas kernel
``flash_decode_pallas``, run as the JAX tests run it on the CPU
(``repro.kernels.ops.flash_decode`` in interpret mode).

The port computes what the TPU kernel computes. In two cases that is not
what the reference's oracle ``flash_decode_ref`` computes — Hkv not
dividing Hq, and a row with no valid slot when W is padded to a multiple
of the chunk — and the tests below record both.

Tolerances: float32 rtol = atol = 2e-5 (the two sides sum the softmax
and P.V in another order; the reference's own sweep uses 2e-5); bf16
rtol = atol = 4e-2 (the reference's own bf16 tolerance: scores rounded
to bf16 on both sides may round differently after float32 sums in
another order, and the output is rounded to bf16).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops, ref as ref_oracle  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_decode import (chunk_padding,  # noqa: E402
                                              flash_decode_plain, n_rep_of)

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 4e-2}


def _operands(seed, b, hq, hkv, dh, w, valid_frac=0.7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    valid = rng.uniform(size=(b, w)) < valid_frac
    return q, k, v, valid


def _both(q, k, v, valid, dtype, chunk):
    """(port on CPU tensors, reference kernel in interpret mode) as f32."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = ops.flash_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(valid), chunk=chunk)
    assert got.dtype == tdt and got.shape == q.shape
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    want = ref_ops.flash_decode(*jargs, jnp.asarray(valid), chunk=chunk)
    return got.float().numpy(), np.asarray(want, np.float32), jargs


@pytest.mark.parametrize("b,hq,hkv,dh,w", [
    (2, 8, 2, 32, 100), (1, 4, 4, 64, 513), (3, 25, 5, 16, 64), (2, 48, 8, 32, 257),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas_sweep(b, hq, hkv, dh, w, dtype):
    """The reference's sweep (slot 0 always valid), chunk 64."""
    q, k, v, valid = _operands(b * 7 + w, b, hq, hkv, dh, w)
    valid[:, 0] = True
    got, want, _ = _both(q, k, v, valid, dtype, chunk=64)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_ring_buffer_mask(dtype):
    """A wrapped ring buffer: each row's valid slots are the positions in
    (pos - window, pos], stored at slot position % W."""
    b, hq, hkv, dh, w, window = 3, 12, 4, 32, 48, 20
    q, k, v, _ = _operands(5, b, hq, hkv, dh, w)
    pos = np.asarray([7, 47, 130])
    kpos = np.full((b, w), np.iinfo(np.int32).max // 2)
    for i, p in enumerate(pos):
        for t in range(max(0, p - w + 1), p + 1):
            kpos[i, t % w] = t
    valid = (kpos <= pos[:, None]) & (kpos > pos[:, None] - window)
    got, want, _ = _both(q, k, v, valid, dtype, chunk=16)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_hq_not_a_multiple_of_hkv():
    """Hq 6 over Hkv 4: the kernel (and the port) give query head h the KV
    head h // ceil(6/4) = h // 2, so KV head 3 serves no query head; the
    oracle gives it min(h // 1, 3). Port == kernel to 2e-5; the oracle
    differs."""
    assert n_rep_of(6, 4) == 2
    q, k, v, valid = _operands(11, 2, 6, 4, 16, 40)
    valid[:, 0] = True
    got, want, jargs = _both(q, k, v, valid, "float32", chunk=16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    oracle = np.asarray(ref_oracle.flash_decode_ref(*jargs, jnp.asarray(valid)))
    assert np.abs(oracle - want).max() > 0.1


def test_flash_decode_all_invalid_row_with_chunk_padding():
    """W 40 at chunk 16 pads 8 invalid zero slots. A row with no valid
    slot then averages V over all 48 slots, padding included (the
    oracle: over the 40 real ones). Port == kernel to 2e-5 on every row,
    and the all-invalid row is sum(V) / 48 exactly as designed."""
    assert chunk_padding(40, 16) == 8 and chunk_padding(40, 512) == 0
    q, k, v, valid = _operands(12, 2, 8, 2, 16, 40)
    valid[0] = False
    valid[1, 3] = True
    got, want, jargs = _both(q, k, v, valid, "float32", chunk=16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    hmap = np.arange(8) // 4
    np.testing.assert_allclose(got[0], v[0][:, hmap].sum(0) / 48, rtol=2e-5,
                               atol=2e-5)
    oracle = np.asarray(ref_oracle.flash_decode_ref(*jargs, jnp.asarray(valid)))
    assert np.abs(oracle[0] - want[0]).max() > 1e-2
    np.testing.assert_allclose(oracle[1], want[1], rtol=2e-5, atol=2e-5)


def test_flash_decode_chunk_shows_only_in_rows_without_a_valid_slot():
    """With a valid slot in every row the chunk changes nothing beyond
    float32 roundoff; the plain version is the wrapper's CPU path."""
    q, k, v, valid = _operands(13, 2, 8, 2, 32, 100)
    valid[:, 5] = True
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    a = flash_decode_plain(*t, chunk=16)
    torch.testing.assert_close(a, flash_decode_plain(*t, chunk=512),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(a, ops.flash_decode(*t, chunk=16))
