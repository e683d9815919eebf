"""How the port's K4 (matmul) and K5 (flash-decode) kernels plan their
launches, and torch mirrors of their algorithms held against the
reference's Pallas kernels, run as the JAX tests run them on the CPU
(``repro.kernels.ops`` in interpret mode).

* ``matmul_route`` sends a bf16 x whose shapes and pointers TMA can
  describe to the wgmma kernel and everything else to the SIMT kernel;
  ``matmul_splits`` splits K only for narrow products.
* ``decode_splits`` cuts W into splits that cover it exactly and give at
  least two blocks per SM at the LM's decode shape, and four at the
  ``long_500k`` rank call.
* K5's split-skip-merge (per split: only the valid slots; then a merge of
  the splits in order; a row with no valid slot averages V over real and
  padded slots) equals the TPU kernel, and so does its tensor-core pass
  as the kernel runs it (whole GQA groups of up to 16 query heads per
  block, 16-slot warp steps, the warps' states merged in warp order, the
  splits merged by 16 warps over fixed ranges, P.V with P in bf16 hi + lo
  parts), in the normal and the partial mode. Tolerances: float32 rtol =
  atol = 2e-5 (the reference's own sweep tolerance: the sums run in
  another order); bf16 rtol = atol = 4e-2 (the reference's own bf16
  tolerance).
* K4's int8 order on the wgmma route ((x @ codes) * scale, the scale on
  the float32 sum) equals the TPU kernel's (x @ (codes * scale)) within
  atol 2^-20 of max(|x| @ |w|) (float32 rounding order) and, for a bf16
  output, rtol 2^-7 (one bf16 rounding step).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    BLOCKS_PER_SM, MAX_REP_MMA, MAX_SPLIT, MAX_SPLITS, MIN_SPLIT, NEG,
    chunk_padding, decode_splits, default_kv_heads, flash_decode_plain,
    head_groups, head_table, merge_rank_partials, n_rep_of)
from repro_torch.kernels.matmul import (MIN_K_TILES_PER_SPLIT,  # noqa: E402
                                        WGMMA_TILE, dequantized,
                                        matmul_route, matmul_splits)

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 4e-2}
N_SMS = 132                     # the plans are checked for an H100 SXM
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


# ---------------------------------------------------------------------------
# K4: route and split
# ---------------------------------------------------------------------------

def _mm(m, k, n, x_dtype=torch.bfloat16, w_dtype=None):
    x = torch.zeros((m, k), dtype=x_dtype)
    w = torch.zeros((k, n), dtype=w_dtype or x_dtype)
    scale = torch.ones((1, n)) if w.dtype == torch.int8 else None
    return x, w, scale


@pytest.mark.parametrize("m,k,n,x_dtype,w_dtype,route", [
    (2048, 3072, 9216, torch.bfloat16, None, "wgmma"),      # the prefill product
    (4, 3072, 9216, torch.bfloat16, None, "wgmma"),         # the decode product
    (2048, 3072, 9216, torch.bfloat16, torch.int8, "wgmma"),
    (96, 256, 200, torch.bfloat16, None, "wgmma"),          # N % 8 == 0
    (96, 256, 200, torch.bfloat16, torch.int8, "simt"),     # int8 needs N % 16
    (96, 256, 192, torch.bfloat16, torch.int8, "wgmma"),
    (128, 3000, 256, torch.bfloat16, None, "wgmma"),        # K % 8 == 0, not % 64
    (2048, 3072, 9216, torch.float32, None, "simt"),        # float32 stays exact
    (64, 96, 48, torch.float32, torch.int8, "simt"),
    (70, 90, 50, torch.bfloat16, None, "simt"),             # the reference's sweep
    (128, 128, 128, torch.float32, None, "simt"),
    (33, 257, 65, torch.bfloat16, None, "simt"),
    (8, 260, 64, torch.bfloat16, None, "simt"),             # K % 8 != 0
])
def test_matmul_route_by_dtype_and_shape(m, k, n, x_dtype, w_dtype, route):
    assert matmul_route(*_mm(m, k, n, x_dtype, w_dtype)) == route


def test_matmul_route_needs_16_byte_aligned_pointers():
    """A view that starts one element into its storage cannot feed TMA."""
    base = torch.zeros(8 + 64 * 256, dtype=torch.bfloat16)
    x = base[1:1 + 64 * 256].view(64, 256)
    w = torch.zeros((256, 128), dtype=torch.bfloat16)
    assert x.data_ptr() % 16 != 0
    assert matmul_route(x, w) == "simt"
    assert matmul_route(base[8:].view(64, 256), w) == "wgmma"


@pytest.mark.parametrize("m,k,n", [(4, 3072, 9216), (1, 1024, 512), (65, 512, 384),
                                   (2048, 3072, 9216), (96, 256, 192), (300, 4096, 128)])
def test_matmul_splits_cover_k_without_an_empty_split(m, k, n):
    bm, bn, bk = WGMMA_TILE
    tiles = -(-m // bm) * -(-n // bn)
    k_tiles = -(-k // bk)
    s = matmul_splits(m, n, k, N_SMS)
    per = -(-k_tiles // s)
    assert 1 <= s <= k_tiles and (s - 1) * per < k_tiles <= s * per
    if tiles >= N_SMS:
        assert s == 1
    elif s > 1:
        assert per >= MIN_K_TILES_PER_SPLIT


def test_matmul_splits_fill_the_card_at_the_decode_product():
    """(4, 3072) x (3072, 9216): 72 output tiles alone would leave 60 of
    the 132 SMs idle; the split gives at least one block per SM."""
    s = matmul_splits(4, 9216, 3072, N_SMS)
    assert s > 1 and 72 * s >= N_SMS
    assert matmul_splits(2048, 9216, 3072, N_SMS) == 1


# ---------------------------------------------------------------------------
# K5: splits
# ---------------------------------------------------------------------------

def test_decode_splits_fill_the_card_at_the_lm_decode_shape():
    for n_groups in (1, 2):
        length, n = decode_splits(4, 8, n_groups, 4096, N_SMS)
        assert 4 * 8 * n_groups * n >= 2 * N_SMS
        assert length * n == 4096
    assert head_groups(24, 8) == 1 and head_groups(48, 1) == 12


def test_decode_splits_at_the_long_500k_rank_call():
    """hymba-1.5b's global layer on one of 4 data ranks: B 1, 5 head-table
    entries (25 query heads over 5 KV heads, whole groups), 131,072
    slots: within the merge's MAX_SPLITS and at least BLOCKS_PER_SM (4)
    blocks per SM."""
    assert len(head_table(default_kv_heads(25, 5), MAX_REP_MMA)) == 5
    length, n = decode_splits(1, 5, 1, 131072, N_SMS)
    assert n <= MAX_SPLITS and length * n == 131072
    assert 5 * n >= BLOCKS_PER_SM * N_SMS
    assert head_groups(25, 5) == 2


@pytest.mark.parametrize("b,hkv,n_groups,w", [
    (4, 8, 1, 4096), (4, 8, 1, 1000), (2, 1, 12, 777), (1, 1, 1, 1),
    (1, 1, 1, 100), (2, 2, 1, 513), (64, 8, 2, 4096), (3, 5, 1, 64)])
def test_decode_splits_cover_w_exactly(b, hkv, n_groups, w):
    length, n = decode_splits(b, hkv, n_groups, w, N_SMS)
    assert length % 32 == 0 and MIN_SPLIT <= length <= MAX_SPLIT
    assert (n - 1) * length < w <= n * length


# ---------------------------------------------------------------------------
# K5: the split-skip-merge algorithm against the TPU kernel
# ---------------------------------------------------------------------------

def split_skip_merge(q, k, v, valid, chunk, split_len):
    """K5's algorithm in torch: per (b, split), the scores of the valid
    slots only (the float32 dot product rounded to the input dtype, then
    scaled), their max, sum and P.V; then the splits merged in order; a
    row with no valid slot is sum V / (W + pad)."""
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    n_rep = n_rep_of(hq, hkv)
    heads = torch.arange(hq) // n_rep
    pad = chunk_padding(w, chunk)
    out = torch.empty((b, hq, dh), dtype=torch.float32)
    for bi in range(b):
        kf, vf = k[bi][:, heads].float(), v[bi][:, heads].float()   # (W, Hq, Dh)
        if not bool(valid[bi].any()):
            out[bi] = vf.sum(0) / (w + pad)
            continue
        ms, ls, accs = [], [], []
        for s0 in range(0, w, split_len):
            idx = torch.nonzero(valid[bi, s0:s0 + split_len]).flatten() + s0
            if idx.numel() == 0:
                ms.append(torch.full((hq,), NEG))
                ls.append(torch.zeros(hq))
                accs.append(torch.zeros((hq, dh)))
                continue
            s = torch.einsum("hd,whd->hw", q[bi].float(), kf[idx])
            s = s.to(q.dtype).float() * (1.0 / math.sqrt(dh))
            m = s.amax(1)
            p = torch.exp(s - m[:, None])
            ms.append(m)
            ls.append(p.sum(1))
            accs.append(torch.einsum("hw,whd->hd", p, vf[idx]))
        m_all = torch.stack(ms)                                        # (S, Hq)
        mx = m_all.amax(0)
        c = torch.exp(m_all - mx)
        den = (torch.stack(ls) * c).sum(0)
        num = (torch.stack(accs) * c[..., None]).sum(0)
        out[bi] = num / torch.clamp(den, min=1e-20)[:, None]
    return out.to(q.dtype)


def _entries(table):
    """(g, h0, nh) of each packed head-table entry (nh 16 stored as 0)."""
    return [(e >> 16, (e >> 4) & 0xfff, (e & 0xf) or 16) for e in table]


def _pv(p, vv, dtype):
    """P.V as the tensor-core pass sums it: P in bf16 hi + lo parts for
    bf16 operands, float32 sums."""
    if dtype != torch.bfloat16:
        return p @ vv
    hi = p.to(torch.bfloat16).float()
    return hi @ vv + (p - hi).to(torch.bfloat16).float() @ vv


def whole_group_split_merge(q, k, v, valid, chunk, split_len, kv_heads=None,
                            partial=False, warps=4, merge_warps=16, step=16):
    """K5's tensor-core pass in torch. A block per (b, head-table entry of
    up to MAX_REP_MMA query heads, split): the split's valid slots (all of
    them where the split is full, the compacted ones where it has holes)
    in steps of ``step``, warp i taking steps i, i + warps, ...; each warp
    an online softmax over its steps (scores rounded to the input dtype,
    then scaled); the warps' states merged in warp order into the split's
    partial. Then per (b, h) the splits merged: weights exp(m_s - max),
    the denominator their sum with the splits' l, the numerator in
    ``merge_warps`` ranges of consecutive splits each summed in split
    order, the ranges' sums added in range order. A row with no valid slot
    is sum V / (W + pad), or in the partial mode a zero output and lse
    -inf; otherwise the partial mode returns the float32 output and lse =
    max + log(den)."""
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    kv = default_kv_heads(hq, hkv) if kv_heads is None else tuple(kv_heads)
    scale = 1.0 / math.sqrt(dh)
    n_splits = -(-w // split_len)
    m_p = torch.full((b, hq, n_splits), NEG)
    l_p = torch.zeros((b, hq, n_splits))
    a_p = torch.zeros((b, hq, n_splits, dh))
    count = torch.zeros((b, n_splits), dtype=torch.long)
    for bi in range(b):
        for g, h0, nh in _entries(head_table(kv, MAX_REP_MMA)):
            qe = q[bi, h0:h0 + nh].float()
            for s in range(n_splits):
                idx = torch.nonzero(valid[bi, s * split_len:(s + 1) * split_len]
                                    ).flatten() + s * split_len
                count[bi, s] = idx.numel()
                steps = [idx[i:i + step] for i in range(0, idx.numel(), step)]
                states = []
                for wp in range(warps):
                    m, l = torch.full((nh,), NEG), torch.zeros(nh)
                    acc = torch.zeros((nh, dh))
                    for st in steps[wp::warps]:
                        kk, vv = k[bi, st, g].float(), v[bi, st, g].float()
                        sc = (qe @ kk.T).to(q.dtype).float() * scale
                        mx = torch.maximum(m, sc.amax(1))
                        corr = torch.exp(m - mx)
                        p = torch.exp(sc - mx[:, None])
                        l = l * corr + p.sum(1)
                        acc = acc * corr[:, None] + _pv(p, vv, q.dtype)
                        m = mx
                    states.append((m, l, acc))
                mx = torch.stack([st[0] for st in states]).amax(0)
                den, num = torch.zeros(nh), torch.zeros((nh, dh))
                for m, l, acc in states:
                    c = torch.exp(m - mx)
                    den = den + l * c
                    num = num + acc * c[:, None]
                m_p[bi, h0:h0 + nh, s] = mx
                l_p[bi, h0:h0 + nh, s] = den
                a_p[bi, h0:h0 + nh, s] = num
    out = torch.empty((b, hq, dh))
    lse = torch.empty((b, hq))
    per = -(-n_splits // merge_warps)
    pad = chunk_padding(w, chunk)
    for bi in range(b):
        for h in range(hq):
            if int(count[bi].sum()) == 0:
                out[bi, h] = 0.0 if partial else v[bi, :, kv[h]].float().sum(0) / (w + pad)
                lse[bi, h] = -math.inf
                continue
            mx = m_p[bi, h].max()
            c = torch.exp(m_p[bi, h] - mx)
            den = (l_p[bi, h] * c).sum()
            num = torch.zeros(dh)
            for r in range(merge_warps):
                rn = torch.zeros(dh)
                for s in range(r * per, min(n_splits, (r + 1) * per)):
                    rn = rn + a_p[bi, h, s] * c[s]
                num = num + rn
            out[bi, h] = num / torch.clamp(den, min=1e-20)
            lse[bi, h] = mx + torch.log(den)
    return (out, lse) if partial else out.to(q.dtype)


def _k5_case(seed, b, hq, hkv, dh, w):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    valid = np.zeros((b, w), dtype=bool)
    return rng, q, k, v, valid


def _k5_check(q, k, v, valid, dtype, chunk, split_len):
    got = split_skip_merge(*(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)),
                           torch.from_numpy(valid), chunk, split_len)
    want = ref_ops.flash_decode(*(jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)),
                                jnp.asarray(valid), chunk=chunk)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_split_skip_merge_matches_pallas_with_empty_splits_and_rows(dtype):
    """W 200 in splits of 64 (ragged last split), chunk 64 (56 padded
    slots): row 0 has no valid slot, row 1 valid slots only in its third
    split, row 2 a single valid slot at W - 1, row 3 a random mask."""
    rng, q, k, v, valid = _k5_case(21, 4, 8, 2, 32, 200)
    valid[1, 140:180] = rng.uniform(size=40) < 0.5
    valid[1, 150] = True
    valid[2, 199] = True
    valid[3] = rng.uniform(size=200) < 0.6
    got = _k5_check(q, k, v, valid, dtype, chunk=64, split_len=64)
    if dtype == "float32":
        hmap = np.arange(8) // 4
        np.testing.assert_allclose(got[0].numpy(), v[0][:, hmap].sum(0) / 256,
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[2].numpy(), v[2, 199][hmap], rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("b,hq,hkv,dh,w,chunk,split_len", [
    (2, 6, 4, 16, 100, 16, 32),      # Hkv not dividing Hq, padded W
    (1, 48, 1, 32, 777, 256, 64),    # MQA, B * Hkv = 1
    (2, 24, 8, 64, 513, 512, 128),   # one slot past a split boundary
])
def test_k5_split_skip_merge_matches_pallas_ring_masks(b, hq, hkv, dh, w, chunk,
                                                       split_len):
    """Ring-buffer masks (each row's newest positions), with row 0 empty."""
    rng, q, k, v, valid = _k5_case(b * w + hq, b, hq, hkv, dh, w)
    for bi in range(b):
        pos = int(rng.integers(0, 3 * w))
        latest = pos - (pos - np.arange(w)) % w
        valid[bi] = (latest >= 0) & (latest > pos - w // 3)
    valid[0] = False
    _k5_check(q, k, v, valid, "float32", chunk, split_len)


def test_k5_dropping_invalid_slots_is_exact_beyond_float_order():
    """Split lengths change only the float32 order of the sums."""
    _, q, k, v, valid = _k5_case(33, 2, 8, 2, 32, 300)
    valid[:] = np.random.default_rng(34).uniform(size=valid.shape) < 0.3
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    a = split_skip_merge(*t, 512, 32)
    torch.testing.assert_close(a, split_skip_merge(*t, 512, 512), rtol=1e-6,
                               atol=1e-6)


def _grouped_case(seed, b, hq, hkv, dh, w, mask):
    """"dense": every slot valid (the TMA loader's splits); "holes": 60 %
    of the slots valid (the compacted gather's), row 0 none."""
    rng, q, k, v, valid = _k5_case(seed, b, hq, hkv, dh, w)
    valid[:] = True if mask == "dense" else rng.uniform(size=valid.shape) < 0.6
    if mask == "holes":
        valid[0] = False
    return q, k, v, valid


GROUPED = [(2, 10, 2, 32, 700, 32, "dense"),   # groups of 5, 22 splits in 11 merge ranges
           (2, 14, 2, 32, 400, 64, "holes"),   # groups of 7, a ragged last split
           (2, 17, 1, 32, 300, 32, "holes")]   # a run of 17: entries of 16 and 1


@pytest.mark.parametrize("b,hq,hkv,dh,w,split_len,mask", GROUPED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_whole_group_pass_matches_pallas(b, hq, hkv, dh, w, split_len, mask,
                                            dtype):
    """The tensor-core pass's algorithm (whole groups, warp steps, the
    parallel merge) in the normal mode against the TPU kernel."""
    q, k, v, valid = _grouped_case(hq * w, b, hq, hkv, dh, w, mask)
    got = whole_group_split_merge(*(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)),
                                  torch.from_numpy(valid), 512, split_len)
    want = ref_ops.flash_decode(*(jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)),
                                jnp.asarray(valid), chunk=512)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,dh,w,split_len,mask", GROUPED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_whole_group_pass_partial_mode(b, hq, hkv, dh, w, split_len, mask,
                                          dtype):
    """The same algorithm in the partial mode on two slot shards: each
    shard's lse against the port's plain partial mode (rows with no valid
    slot exactly -inf and zero), and the shards merged in rank order
    against the TPU kernel on the whole cache (a row with no valid slot
    merges to zero, where the kernel averages V)."""
    q, k, v, valid = _grouped_case(hq * w + 1, b, hq, hkv, dh, w, mask)
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)] + [torch.from_numpy(valid)]
    half = w // 2
    outs, lses = [], []
    for lo, hi in ((0, half), (half, w)):
        shard = [x[:, lo:hi].contiguous() for x in t[1:]]
        out, lse = whole_group_split_merge(t[0], *shard, 512, split_len, partial=True)
        w_out, w_lse = flash_decode_plain(t[0], *shard, partial=True)
        empty = torch.isinf(w_lse)
        assert torch.equal(torch.isinf(lse), empty) and not out[empty].any()
        torch.testing.assert_close(lse[~empty], w_lse[~empty], rtol=TOL[dtype],
                                   atol=TOL[dtype])
        outs.append(out)
        lses.append(lse)
    got = merge_rank_partials(outs, lses, TDT[dtype]).float().numpy()
    want = np.asarray(ref_ops.flash_decode(
        *(jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)), jnp.asarray(valid),
        chunk=512), np.float32)
    rows = valid.any(1)
    np.testing.assert_allclose(got[rows], want[rows], rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[~rows].any()


# ---------------------------------------------------------------------------
# K4: the int8 order of the wgmma route against the TPU kernel
# ---------------------------------------------------------------------------

def codes_then_scale(x, codes, scale):
    """The wgmma route's int8 order: codes widened exactly (bf16 holds every
    |code| <= 127), a float32 sum of x times the codes, the column scale on
    the sum, output in x's dtype."""
    return ((x.float() @ codes.float()) * scale).to(x.dtype)


@pytest.mark.parametrize("m,k,n", [(64, 96, 48), (96, 256, 192), (33, 264, 80)])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_k4_int8_scale_on_the_sum_matches_pallas(m, k, n, x_dtype):
    rng = np.random.default_rng(m * n + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    s = (np.abs(w).max(0, keepdims=True) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    xt = torch.from_numpy(x).to(TDT[x_dtype])
    got = codes_then_scale(xt, torch.from_numpy(wq), torch.from_numpy(s))
    want = ref_ops.matmul(jnp.asarray(x).astype(JDT[x_dtype]), jnp.asarray(wq),
                          jnp.asarray(s), bm=32, bn=16, bk=32)
    big = float((xt.float().abs() @ dequantized(torch.from_numpy(wq),
                                                 torch.from_numpy(s)).abs()).max())
    rtol = 2 ** -7 if x_dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=2 ** -20 * big)
