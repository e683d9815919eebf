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

import jax  # noqa: E402
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


def test_head_table_runs_and_in_place_block():
    """``head_table`` packs one entry per run of at most MAX_REP query
    heads on one KV head, in query-head order; the default map is the TPU
    kernel's h // ceil(Hq / Hkv)."""
    from repro_torch.kernels.flash_decode import default_kv_heads, head_table
    unpack = lambda t: [(e >> 16, (e >> 4) & 0xfff, e & 0xf) for e in t]
    assert default_kv_heads(6, 4) == (0, 0, 1, 1, 2, 2)
    assert unpack(head_table((0,) * 6 + (1,) * 2)) == [(0, 0, 4), (0, 4, 2),
                                                      (1, 6, 2)]
    # a rank's heads straddling two KV groups of a cache storing 3 heads
    assert unpack(head_table((1, 1, 2))) == [(1, 0, 2), (2, 2, 1)]
    # padded heads clamp to the last KV head
    assert unpack(head_table((0, 0, 1, 1, 1, 1))) == [(0, 0, 2), (1, 2, 4)]


def _unpack16(table):
    """(g, h0, nh) of each entry; a run of 16 stores 0 in its low bits."""
    return [(e >> 16, (e >> 4) & 0xfff, (e & 0xf) or 16) for e in table]


@pytest.mark.parametrize("hq,hkv,nh", [(25, 5, 5), (48, 8, 6), (56, 8, 7)],
                         ids=["hymba", "grok", "llava"])
def test_head_table_whole_groups_on_the_tensor_core_pass(hq, hkv, nh):
    """With ``max_rep=16`` (the tensor-core pass) a GQA group of up to 16
    query heads is one entry: hymba-1.5b's 25 over 5 KV heads give 5
    entries (10 at MAX_REP 4), grok-1's 48 over 8 and llava-next's 56
    over 8 give 8 each."""
    from repro_torch.kernels.flash_decode import (MAX_REP_MMA,
                                                  default_kv_heads, head_table)
    kv = default_kv_heads(hq, hkv)
    assert _unpack16(head_table(kv, MAX_REP_MMA)) == [(g, g * nh, nh)
                                                      for g in range(hkv)]
    assert len(head_table(kv)) == 2 * hkv


def test_head_table_max_rep_16_runs_padding_and_rank_offsets():
    """Runs longer than 16 split into 16 + the rest; padded heads clamp to
    the last KV head and join its run; a tensor-parallel rank whose heads
    start inside a group reads that group's tail first."""
    from repro_torch.kernels.flash_decode import head_table
    assert _unpack16(head_table((0,) * 17, 16)) == [(0, 0, 16), (0, 16, 1)]
    assert _unpack16(head_table((3,) * 33, 16)) == [(3, 0, 16), (3, 16, 16),
                                                    (3, 32, 1)]
    # 10 real heads over 2 KV heads (groups of 5) padded to 16: the 6
    # padded heads clamp to KV head 1
    padded = tuple(min(h // 5, 1) for h in range(16))
    assert _unpack16(head_table(padded, 16)) == [(0, 0, 5), (1, 5, 11)]
    # rank 1 of 4 over grok-like groups of 6: heads 12..23 of 48 start on
    # KV head 2, in a cache that stores all 8
    rank = tuple(h // 6 for h in range(12, 24))
    assert _unpack16(head_table(rank, 16)) == [(2, 0, 6), (3, 6, 6)]
    straddle = (1, 1, 2, 2, 2, 2, 2, 2)
    assert _unpack16(head_table(straddle, 16)) == [(1, 0, 2), (2, 2, 6)]
    assert _unpack16(head_table(straddle)) == [(1, 0, 2), (2, 2, 4), (2, 6, 2)]


@pytest.mark.parametrize("dtype,dh,aligned,split,rep", [
    ("bfloat16", 64, True, "tensor_core", 16), ("bfloat16", 128, True, "tensor_core", 16),
    ("bfloat16", 32, True, "tensor_core", 16), ("bfloat16", 96, True, "tensor_core", 16),
    ("bfloat16", 16, True, "cuda_core", 4), ("bfloat16", 80, True, "cuda_core", 4),
    ("bfloat16", 128, False, "cuda_core", 4), ("float32", 128, True, "cuda_core", 4),
    ("float32", 64, True, "cuda_core", 4)])
def test_split_pass_picks_the_head_table(dtype, dh, aligned, split, rep):
    """The pass (and with it the table's run width) follows the kernel's
    own choice: bf16 with Dh % 32 == 0 and 16-byte aligned K / V take the
    tensor-core pass and runs of 16, everything else runs of 4."""
    from repro_torch.kernels.flash_decode import pass_max_rep, split_pass
    tdt = getattr(torch, dtype)
    assert split_pass(tdt, dh, aligned) == split
    assert pass_max_rep(tdt, dh, aligned) == rep


def test_launch_table_reads_alignment_from_the_storage_offset():
    """``launch_table`` plans from the operands: hymba's map in bf16 is 5
    entries; the same cache two bytes off a 16-byte boundary (a view one
    element into its storage) takes the CUDA-core pass and 10 entries;
    float32 likewise 10."""
    from repro_torch.kernels.flash_decode import launch_table
    q = torch.zeros((1, 25, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 32, 5, 64), dtype=torch.bfloat16)
    assert len(launch_table(q, k, k)) == 5
    flat = torch.zeros(k.numel() + 8, dtype=torch.bfloat16)
    off = flat[1:1 + k.numel()].view(k.shape)
    assert len(launch_table(q, off, off)) == 10
    assert len(launch_table(q.float(), k.float(), k.float())) == 10
    assert len(launch_table(q, k, k, kv_heads=(4,) * 25)) == 2


@pytest.mark.parametrize("kv_heads", [(1, 1, 2), (2, 2, 2, 2, 2, 0),
                                      (0, 0, 1, 1, 1, 1)],
                         ids=["straddle", "offset", "padded"])
def test_flash_decode_head_map_matches_gathered_heads(kv_heads):
    """With ``kv_heads`` each query head reads its own stored KV head in
    place: the wrapper (the plain version on the CPU) equals the default
    map run on the KV heads gathered per query head (one KV head per
    query head), and the oracle given those gathered heads."""
    hq = len(kv_heads)
    q, k, v, valid = _operands(21 + hq, 2, hq, 3, 16, 40)
    valid[:, 0] = True
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = ops.flash_decode(*t, chunk=16, kv_heads=kv_heads)
    idx = list(kv_heads)
    want = flash_decode_plain(t[0], t[1][:, :, idx].contiguous(),
                              t[2][:, :, idx].contiguous(), t[3], chunk=16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    oracle = np.asarray(ref_oracle.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(k[:, :, idx]), jnp.asarray(v[:, :, idx]),
        jnp.asarray(valid)))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


def test_flash_decode_plain_head_table_against_reference_attn_decode():
    """The padded-heads model (4 query heads over 2 KV heads, padded to
    6): the reference's attn_decode over a filled cache, and the port's
    plain K5 with the model's map on the same cache, the padded heads
    masked and multiplied by wo, agree to 2e-5."""
    from repro.models import layers as RL
    from repro.models.common import ModelConfig as RCfg
    from repro_torch.models import layers as L
    from repro_torch.models.common import ModelConfig
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, pad_heads_to=6,
              d_ff=32, vocab_size=32)
    rcfg = RCfg(dtype=jnp.float32, **kw)
    cfg = ModelConfig(dtype=torch.float32, **kw)
    p = RL.attn_init(jax.random.PRNGKey(3), rcfg)
    rng = np.random.default_rng(4)
    cache = RL.attn_cache_init(rcfg, 2, 8)
    _, cache = RL.attn_prefill(p, rcfg, jnp.asarray(rng.normal(
        size=(2, 5, 32)).astype(np.float32)), jnp.arange(5, dtype=jnp.int32),
        cache, jnp.asarray(0, jnp.int32))
    x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
    pos = jnp.asarray([5, 5], jnp.int32)
    want, rc = RL.attn_decode(p, rcfg, jnp.asarray(x1), cache, pos,
                              jnp.asarray(0, jnp.int32))
    tp = {k2: torch.from_numpy(np.array(v2)) for k2, v2 in p.items()}
    q = torch.einsum("bsd,dhk->bshk", torch.from_numpy(x1), tp["wq"])
    from repro_torch.models.common import rope
    q = rope(q, torch.tensor([[5], [5]], dtype=torch.int32), cfg.rope_theta)
    kc, vc = (torch.from_numpy(np.asarray(rc[n])) for n in ("k", "v"))
    valid = torch.from_numpy(np.asarray(rc["kpos"])) <= 5
    blk = L.head_block(cfg, tp)
    kv_heads = L.decode_kv_heads(cfg, blk, kc.shape[2])
    assert kv_heads == (0, 0, 1, 1, 1, 1)
    out = flash_decode_plain(q[:, 0].contiguous(), kc, vc, valid,
                             kv_heads=kv_heads)
    out = out * torch.tensor([1., 1., 1., 1., 0., 0.])[None, :, None]
    got = torch.einsum("bhk,hkd->bd", out, tp["wo"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=2e-5, atol=2e-5)
