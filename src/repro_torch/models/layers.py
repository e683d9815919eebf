"""GQA attention (full / blockwise / sliding-window / decode), the MLP,
the capacity-based MoE and the Mamba2 SSD mixer (port of
``repro/models/layers.py``).

Per-layer params are plain dicts, stacked by the decoder on a leading
layer axis. The reference's sharding hints (``_constrain_attn`` and the
``acts.constrain_*`` calls) pin activation shardings on a device mesh;
the port computes the splits they ask for explicitly. Under the pure-DP
strategy's sequence split (``act_sharding.seq_split``, the reference's
``seq_shard``: ``constrain_stream`` on every (B, S, ...) stream, q on
the rank's rows and K / V over the batch only) a layer computes the
rank's rows: attention gathers K and V over the model axis
(:func:`_attn_split_body`, :func:`attn_prefill_body`; the blockwise
pass takes queries offset into the keys), the MLP is row-wise, and the
SSD mixer passes its state from rank to rank (:func:`ssd_split_body`).

Tensor parallelism (the reference's SPMD partition of a serving cell):
under ``act_sharding.tensor_parallel`` a layer computes on the rank's
shards of its leaves, each split read from the leaf's shape. Attention
projects the rank's query heads (column-parallel ``wq``) and its KV
heads (``wk`` / ``wv``, whole where the rules replicate them), reads the
contiguous block of KV heads its query heads map to (:class:`HeadBlock`)
and multiplies by its rows of ``wo``; the MLP takes its columns of
``w_up`` / ``w_gate`` and rows of ``w_down``; the MoE runs its experts
(:func:`moe_ep_body`) or, where the experts do not split, every expert
on its slice of the expert FFN dim. The rank body steps
:func:`attn_prefill_body`, :func:`attn_decode_body`, :func:`mlp_body`
and :func:`moe_body` then ask for the model axis's sum. Off a mesh those
steps ask for nothing and compute what the plain functions compute. The
SSD mixer has no such split: a rank gathers its leaves whole
(``train.step.model_gathered``). Training (:func:`attn_body` and the
same MLP and MoE steps with grad on) adds Megatron's copy into each
split region (:func:`enter_heads`, ``act_sharding.model_copy``), whose
backward sums the ranks' cotangents, and checkpoints the local pieces
between collectives under :func:`remat_pieces`.

One deviation from the reference: :func:`attn_decode` computes its
attention through ``kernels.ops.flash_decode`` (kernel K5 on the card,
its plain version on the CPU, handed the model's query-to-KV head map),
where the reference computes it in plain jnp. K5 masks with -1e30
instead of ``BIG_NEG`` (no effect while the token's own slot is valid),
keeps the probabilities in float32 where the reference rounds them to
the model dtype, and sums P.V in float32.

:func:`moe_apply` keeps the reference's routing exactly (``lax.top_k``'s
tie order, the stable sort that decides which assignments a full expert
drops) and combines without atomics: each token sums its ``k``
contributions in float32 in a fixed order and rounds once, so two runs,
and a CUDA graph replay and the eager step, are bitwise equal. The
reference's scatter-add rounds after each add in the model dtype. Under
an activation policy whose model axis divides the experts it takes the
expert-parallel path, :func:`moe_apply_ep`: each rank's partial sum
stays in float32 through the all-reduce and is rounded once. The
tensor-parallel sums do the same (``act_sharding.model_sum``), where
XLA's all-reduce sums in the model dtype.

The SSD mixer's decode writes its ``ssm`` and ``conv`` caches in place,
as :func:`attn_decode` does its KV cache, where the reference returns
new ones; a captured decode step reads fixed addresses."""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.pap import topk_stable
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (default_kv_heads,
                                              merge_rank_partials)
from repro_torch.models.common import (ModelConfig, gelu, init_dense, rms_norm,
                                       rope)

BIG_NEG = -1e9
INT32_MAX = int(np.iinfo(np.int32).max)
#: kpos of a slot never written: a FUTURE position, so ``kpos <= pos``
#: masks it until it is written
EMPTY_SLOT = INT32_MAX // 2


# ===========================================================================
# GQA attention
# ===========================================================================

def attn_init(cfg: ModelConfig, gen: torch.Generator, lead=(), device=None) -> dict:
    """``lead`` prepends dimensions to every leaf (the decoder's layer
    axis)."""
    d, dh, hq, hkv = cfg.d_model, cfg.dh, cfg.h_phys, cfg.n_kv_heads
    lead = tuple(lead)
    return {
        "wq": init_dense(gen, lead + (d, hq, dh), d, cfg.dtype, device),
        "wk": init_dense(gen, lead + (d, hkv, dh), d, cfg.dtype, device),
        "wv": init_dense(gen, lead + (d, hkv, dh), d, cfg.dtype, device),
        "wo": init_dense(gen, lead + (hq, dh, d), hq * dh, cfg.dtype, device),
    }


def attn_axes(cfg: ModelConfig) -> dict:
    return {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, hkv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, hkv, n_rep, dh).reshape(
        b, s, hkv * n_rep, dh)


def _q_to_kv(cfg: ModelConfig) -> np.ndarray:
    """The KV head each PHYSICAL q head reads: the usual GQA grouping;
    padded q heads clamp to the last kv head (their output is masked)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    return np.minimum(np.arange(cfg.h_phys) // n_rep, cfg.n_kv_heads - 1)


class HeadBlock(NamedTuple):
    """The query heads a rank computes, ``[q0, q0 + nq)``, the KV heads
    they read, ``[kv0, kv0 + nkv)``, and the first KV head of the rank's
    stored KV shard (0 where the KV heads are whole). ``split``: the
    query heads are split over the model axis (``wo`` row-parallel)."""
    q0: int
    nq: int
    kv0: int
    nkv: int
    kv_stored0: int
    split: bool


def head_block(cfg: ModelConfig, p: dict) -> HeadBlock:
    """The rank's :class:`HeadBlock` under the tensor-parallel context:
    its query heads are the ``wq`` shard it holds, its KV heads the
    contiguous block those heads map to. Raises where the KV heads are
    split and the query heads whole (no rank's KV shard serves its
    heads)."""
    tp = acts.tensor_parallel_context()
    hq, hkv = p["wq"].shape[-2], p["wk"].shape[-2]
    if tp is None or (hq == cfg.h_phys and hkv == cfg.n_kv_heads):
        return HeadBlock(0, cfg.h_phys, 0, cfg.n_kv_heads, 0, False)
    if hq == cfg.h_phys:
        raise ValueError(f"{cfg.name}: KV heads split over the model axis "
                         "while the query heads are whole")
    q0 = tp.index * hq
    qmap = _q_to_kv(cfg)[q0:q0 + hq]
    kv0, kv1 = int(qmap.min()), int(qmap.max()) + 1
    stored0 = 0 if hkv == cfg.n_kv_heads else tp.index * hkv
    if kv0 < stored0 or kv1 > stored0 + hkv:
        raise ValueError(f"{cfg.name}: query heads {q0}..{q0 + hq - 1} read "
                         f"KV heads {kv0}..{kv1 - 1}, outside the rank's "
                         f"{stored0}..{stored0 + hkv - 1}")
    return HeadBlock(q0, hq, kv0, kv1 - kv0, stored0, True)


def _kv_for_q(cfg: ModelConfig, k: torch.Tensor,
              blk: HeadBlock | None = None) -> torch.Tensor:
    """Map the stored kv heads of ``k`` to the q heads of ``blk`` (all
    the PHYSICAL q heads without one): the usual GQA repeat without
    padding; with padded q heads, real heads keep their q->kv grouping
    and padded heads clamp to the last kv head (their output is masked)."""
    if blk is not None and blk.split:
        idx = _q_to_kv(cfg)[blk.q0:blk.q0 + blk.nq] - blk.kv_stored0
        return k[:, :, torch.from_numpy(idx).to(k.device)]
    if cfg.h_phys == cfg.n_heads:
        return _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    return k[:, :, torch.from_numpy(_q_to_kv(cfg)).to(k.device)]


def _head_mask(cfg: ModelConfig, dtype, device=None,
               blk: HeadBlock | None = None):
    if cfg.h_phys == cfg.n_heads:
        return None
    m = torch.zeros((cfg.h_phys,), dtype=dtype, device=device)
    m[:cfg.n_heads] = 1.0
    return m if blk is None else m[blk.q0:blk.q0 + blk.nq]


def _window(window) -> int:
    """A layer's window: <= 0 means full causal."""
    window = int(window)
    return window if window > 0 else EMPTY_SLOT


def _causal_window_mask(qpos, kpos, window):
    win = _window(window)
    return (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - win)


def _attn_dense(q, k, v, qpos, kpos, window):
    """Whole-matrix attention (small S). q (B,S,Hq,Dh), k/v (B,Sk,Hq,Dh)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    mask = _causal_window_mask(qpos, kpos, window)
    scores = torch.where(mask[None, None], scores, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attn_blockwise(q, k, v, window, chunk: int, q0: int = 0):
    """Flash-style online-softmax attention, O(chunk²) memory per step.

    q (B,Sq,Hq,Dh) at positions ``q0 .. q0 + Sq``, k/v (B,Sk,Hq,Dh) at
    ``0 .. Sk`` (kv already repeated; Sq = Sk and q0 = 0 off a sequence
    split). Every q chunk (``chunk`` rows, or all Sq where fewer) scans
    every kv chunk, masked by causality and the window, as the
    reference's ``lax.scan`` does."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    assert sk % chunk == 0, (sk, chunk)
    qc = min(chunk, sq)
    assert sq % qc == 0, (sq, qc)
    nk = sk // chunk
    scale = 1.0 / math.sqrt(dh)
    ar_q = torch.arange(qc, dtype=torch.int32, device=q.device)
    ar_k = torch.arange(chunk, dtype=torch.int32, device=q.device)
    outs = []
    for qi in range(sq // qc):
        q_i = q[:, qi * qc:(qi + 1) * qc]
        m = torch.full((b, h, qc), BIG_NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, qc, dh), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            k_j = k[:, kj * chunk:(kj + 1) * chunk]
            v_j = v[:, kj * chunk:(kj + 1) * chunk]
            s_ij = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j).float() * scale
            mask = _causal_window_mask(q0 + qi * qc + ar_q, kj * chunk + ar_k,
                                       window)
            s_ij = torch.where(mask[None, None], s_ij, BIG_NEG)
            m_new = torch.maximum(m, s_ij.amax(-1))
            p = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), v_j).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-20)
        outs.append(out.transpose(1, 2).to(q.dtype))           # (B,C,H,Dh)
    return torch.cat(outs, dim=1)


def _project_qkv(p, cfg, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _attend(cfg, q, k, v, positions, window, blk=None, split=None):
    """The full-sequence attention of forward and prefill over the q
    heads of ``blk``: blockwise when the sequence is long and divides
    into ``attn_chunk``, else dense; padded heads masked. Under a
    sequence split (``split``, an ``act_sharding.SeqSplit``) q holds the
    rank's rows at ``positions`` and k / v the whole sequence."""
    s = k.shape[1]
    q0, kpos = 0, positions
    if split is not None:
        q0 = split.start
        kpos = torch.arange(s, dtype=torch.int32, device=q.device)
    if cfg.attn_impl != "dense" and s > 2 * cfg.attn_chunk \
            and s % cfg.attn_chunk == 0:
        out = _attn_blockwise(q, _kv_for_q(cfg, k, blk),
                              _kv_for_q(cfg, v, blk), window, cfg.attn_chunk,
                              q0)
    else:
        out = _attn_dense(q, _kv_for_q(cfg, k, blk), _kv_for_q(cfg, v, blk),
                          positions, kpos, window)
    mask = _head_mask(cfg, out.dtype, out.device, blk)
    if mask is not None:
        out = out * mask[None, None, :, None]
    return out


_PIECES: contextvars.ContextVar = contextvars.ContextVar(
    "remat_pieces", default=False)


@contextlib.contextmanager
def remat_pieces(on: bool):
    """Inside the block (a training rank body, ``decoder.forward_body``)
    :func:`piece` checkpoints the local pieces of the layers."""
    token = _PIECES.set(bool(on))
    try:
        yield
    finally:
        _PIECES.reset(token)


def piece(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, a local piece of a layer between two collectives,
    as a checkpointed region under :func:`remat_pieces` with grad on
    (backward recomputes it). A region cannot hold a collective: backward
    could not replay a rank body's step. ``fn`` reads nothing but its
    arguments, since backward may recompute it outside the rank's
    context. As :func:`decoder.remat`, it stashes no RNG state."""
    if _PIECES.get() and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def prenorm(ln, cfg, x):
    """``x`` through the RMS norm of scale ``ln`` (None: as is)."""
    return x if ln is None else rms_norm(ln, x, cfg.norm_eps)


def _qkv_core(p, cfg, x, positions, ln):
    """The norm (``ln``) and the rotated q, k, v of ``x``'s rows."""
    return _project_qkv(p, cfg, prenorm(ln, cfg, x), positions[None])


def _attend_out(p, cfg, q, k, v, positions, window, blk, split):
    """:func:`_attend` and the product by ``wo`` (under a sequence split
    ``split``, the rank's rows against the whole K / V)."""
    out = _attend(cfg, q, k, v, positions, window, blk, split)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _attn_core(p, cfg, x, positions, window, blk, ln=None):
    """The norm (``ln``), the projections, the attention over the q heads
    of ``blk`` and the product by the rank's rows of ``wo``."""
    q, k, v = _qkv_core(p, cfg, x, positions, ln)
    return _attend_out(p, cfg, q, k, v, positions, window, blk, None)


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, window) -> torch.Tensor:
    """Full-sequence causal attention. x (B,S,D); positions (S,) int32.
    Under the tensor-parallel context, the rank's partial output."""
    return _attn_core(p, cfg, x, positions, window, head_block(cfg, p))


def enter_heads(p: dict, cfg: ModelConfig, x: torch.Tensor, blk: HeadBlock,
                ln=None):
    """Rank body step: where the rank computes a block of query heads,
    ``x`` (the layer's input, before its norm ``ln``), ``ln`` and the KV
    projections that the rules replicate but the rank reads in part
    (``wk`` / ``wv`` whole while the query heads split, as minitron-8b's
    8 KV heads on 16 ranks) go through ``act_sharding.model_copy``: a
    value every rank holds alike, used by each rank's region in part;
    returns (p, x, ln) to compute on."""
    if not blk.split:
        return p, x, ln
    x = yield from acts.model_copy(x)
    if ln is not None:
        ln = yield from acts.model_copy(ln)
    if p["wk"].shape[-2] == cfg.n_kv_heads:
        p = dict(p, wk=(yield from acts.model_copy(p["wk"])),
                 wv=(yield from acts.model_copy(p["wv"])))
    return p, x, ln


def attn_body(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window, ln=None):
    """Rank body step of the training forward's attention over the norm
    (scale ``ln``) of ``x``: full sequence, causal with ``window``, no
    cache; on the rank's query heads under the tensor-parallel context,
    then the model axis's sum. The norm is computed inside the rank's
    region, so one remat piece (:func:`piece`) runs from the layer's
    input to the partial output and keeps only that input."""
    blk = head_block(cfg, p)
    split = acts.seq_split_context()
    if split is not None:
        return (yield from _attn_split_body(p, cfg, x, positions, window, ln,
                                            blk, split))
    p, x, ln = yield from enter_heads(p, cfg, x, blk, ln)
    y = piece(cfg, _attn_core, p, cfg, x, positions, window, blk, ln)
    return (yield from row_sum(blk, y))


def _check_split_heads(cfg, blk):
    if blk.split:
        raise ValueError(f"{cfg.name}: a sequence split computes every head "
                         "on the rank's rows; the query heads are split")


def _attn_split_body(p, cfg, x, positions, window, ln, blk, split):
    """Rank body step: the attention of the rank's rows of a sequence
    split (``act_sharding.seq_split``, the reference's ``seq_shard``):
    q, k, v of its rows at their global ``positions``, K and V gathered
    over the split's axis (``act_sharding.seq_gather``: backward, the
    group's summed cotangents of the rank's rows), then its queries
    against the whole sequence, causal with ``window`` on global
    positions. Two remat pieces, either side of the gather."""
    _check_split_heads(cfg, blk)
    q, k, v = piece(cfg, _qkv_core, p, cfg, x, positions, ln)
    k = yield from acts.seq_gather(split, k)
    v = yield from acts.seq_gather(split, v)
    return piece(cfg, _attend_out, p, cfg, q, k, v, positions, window, blk,
                 split)


def row_sum(blk: HeadBlock, y: torch.Tensor):
    """Rank body step: the model axis's sum of ``y``, the product by the
    rank's rows of ``wo``, where the query heads are split."""
    if blk.split:
        y = yield from acts.model_sum(y)
    return y


def attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int, lead=(),
                    device=None) -> dict:
    """Ring-buffer cache; ``kpos`` holds each slot's position, and empty
    slots carry the future-position sentinel ``EMPTY_SLOT``."""
    lead = tuple(lead)
    shape = lead + (batch, cache_len, cfg.n_kv_heads, cfg.dh)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "kpos": torch.full(lead + (batch, cache_len), EMPTY_SLOT,
                           dtype=torch.int32, device=device),
    }


def attn_prefill(p, cfg, x, positions, cache, window):
    """Forward over S tokens + write cache slots [0..S). Requires S<=W.
    Writes ``cache``'s tensors in place (the reference returns new ones)
    and returns (y, cache); under the tensor-parallel context ``cache``
    holds the rank's KV heads and ``y`` is the rank's partial output."""
    w = cache["k"].shape[1]
    q, k, v = _project_qkv(p, cfg, x, positions[None])
    out = _attend(cfg, q, k, v, positions, window, head_block(cfg, p))
    slots = (positions % w).long()
    cache["k"][:, slots] = k
    cache["v"][:, slots] = v
    cache["kpos"][:, slots] = positions[None].to(torch.int32)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def stored_heads(kv: torch.Tensor, leaf: torch.Tensor, split) -> torch.Tensor:
    """The KV heads of ``kv`` (B, S, Hkv, Dh) that a cache ``leaf`` of a
    sequence-split rank stores: all of them, or the rank's block where the
    cache's spec splits the KV heads over the split's axis."""
    hc = leaf.shape[2]
    if hc == kv.shape[2]:
        return kv
    return kv[:, :, split.index * hc:(split.index + 1) * hc]


def attn_prefill_body(p, cfg, x, positions, cache, window):
    """Rank body step: :func:`attn_prefill` and the sum over the model
    axis. Under a sequence split (``act_sharding.seq_split``) the rank's
    rows attend over K / V gathered over the split's axis, and every rank
    writes the whole cache from the gathered K / V (its stored KV heads
    where the cache's spec splits them)."""
    split = acts.seq_split_context()
    if split is not None:
        blk = head_block(cfg, p)
        _check_split_heads(cfg, blk)
        q, k, v = _project_qkv(p, cfg, x, positions[None])
        k = yield from acts.seq_gather(split, k)
        v = yield from acts.seq_gather(split, v)
        y = _attend_out(p, cfg, q, k, v, positions, window, blk, split)
        kpos = torch.arange(split.total, dtype=torch.int32, device=x.device)
        slots = (kpos % cache["k"].shape[1]).long()
        cache["k"][:, slots] = stored_heads(k, cache["k"], split)
        cache["v"][:, slots] = stored_heads(v, cache["v"], split)
        cache["kpos"][:, slots] = kpos[None]
        return y, cache
    y, cache = attn_prefill(p, cfg, x, positions, cache, window)
    y = yield from row_sum(head_block(cfg, p), y)
    return y, cache


@functools.lru_cache(maxsize=None)
def _decode_map(h_phys: int, n_heads: int, n_kv: int, q0: int, nq: int,
                stored0: int, n_stored: int):
    n_rep = n_heads // n_kv
    qmap = np.minimum(np.arange(h_phys) // n_rep, n_kv - 1)[q0:q0 + nq] - stored0
    mine = tuple(int(g) for g in qmap)
    return None if mine == default_kv_heads(nq, n_stored) else mine


def decode_kv_heads(cfg: ModelConfig, blk: HeadBlock, n_stored: int):
    """The KV head of the ``n_stored`` the rank's cache holds that each of
    its query heads reads, as K5 takes it (``kv_heads``): the model's map
    (:func:`_q_to_kv`, padded heads clamped to the last KV head) over the
    query heads of ``blk``; None where it is K5's default map. Raises
    where the reference cannot map the heads either (Hkv does not divide
    Hq and no heads are padded)."""
    if cfg.h_phys == cfg.n_heads and cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"attn_decode: {cfg.name} has {cfg.n_heads} query "
                         f"heads over {cfg.n_kv_heads} KV heads and no padded "
                         "heads; the GQA repeat needs Hkv to divide Hq")
    return _decode_map(cfg.h_phys, cfg.n_heads, cfg.n_kv_heads, blk.q0,
                       blk.nq, blk.kv_stored0, n_stored)


def _ring_write(cache: dict, pos, k1, v1, split) -> None:
    """Write each row's new token into slot ``pos % W`` of the ring
    buffer, in place (k, v and kpos). On a cache split over its length
    (``split``: this rank holds slots [index * Wl, (index + 1) * Wl) of W
    = size * Wl) only the rank that owns the slot changes it: a rank
    that does not rewrites its clamped slot with what that slot holds,
    so no host read decides who writes. The reference's scatter into the
    sharded dim writes the same (``src/repro/models/layers.py``)."""
    b, wl = k1.shape[0], cache["k"].shape[1]
    bidx = torch.arange(b, device=k1.device)
    if split is None:
        slot = (pos % wl).long()
        cache["k"][bidx, slot] = k1
        cache["v"][bidx, slot] = v1
        cache["kpos"][bidx, slot] = pos
        return
    local = (pos % (wl * split.size)).long() - split.index * wl
    mine = (local >= 0) & (local < wl)
    local = local.clamp(0, wl - 1)
    for name, new in (("k", k1), ("v", v1), ("kpos", pos)):
        keep = mine.view((b,) + (1,) * (new.dim() - 1))
        cache[name][bidx, local] = torch.where(keep, new,
                                               cache[name][bidx, local])


def _split_attention(q, kc, vc, valid, kv_heads, split, dtype):
    """Rank body step: the attention over a cache split over its length:
    K5's partial mode on the rank's slots, read in place, then the
    (output, lse) rows of every rank of the split axes (one all-gather
    of (B, Hq, Dh + 1) float32) merged in rank order
    (``kernels.flash_decode.merge_rank_partials``)."""
    out, lse = ops.flash_decode(q, kc, vc, valid, kv_heads=kv_heads,
                                partial=True)
    rows = yield C.all_gather(split.axes, torch.cat(
        [out, lse[..., None]], -1)[None], 0)
    return merge_rank_partials(rows[..., :-1].unbind(0),
                               rows[..., -1].unbind(0), dtype)


def attn_decode_body(p, cfg, x1, cache, pos, window):
    """Rank body step: one-token decode. x1 (B,1,D); pos (B,) int32
    per-request positions (continuous batching); ring-buffer cache,
    written in place. The attention runs through ``ops.flash_decode``
    (K5) with the model's query-to-KV head map (:func:`decode_kv_heads`),
    which reads the rank's KV heads in place in a cache that stores more;
    padded heads are masked after it, as the reference masks them. Under
    the tensor-parallel context it computes the rank's query heads and
    asks for the model axis's sum. Under ``act_sharding.cache_split`` the
    cache is the rank's slice of the slots: the owner of the new slot
    writes it and the ranks' partial attentions are merged
    (:func:`_split_attention`), where the reference's partitioner
    reduces over the split dim."""
    blk = head_block(cfg, p)
    split = acts.cache_split_context()
    q, k, v = _project_qkv(p, cfg, x1, pos[:, None])
    _ring_write(cache, pos, k[:, 0], v[:, 0], split)
    kpos = cache["kpos"]
    valid = (kpos <= pos[:, None]) & (kpos > pos[:, None] - _window(window))
    kc, vc = cache["k"], cache["v"]
    kv_heads = decode_kv_heads(cfg, blk, kc.shape[2])
    if split is None:
        out = ops.flash_decode(q[:, 0].contiguous(), kc, vc, valid,
                               kv_heads=kv_heads)
    else:
        out = yield from _split_attention(q[:, 0].contiguous(), kc, vc, valid,
                                          kv_heads, split, q.dtype)
    mask = _head_mask(cfg, out.dtype, out.device, blk)
    if mask is not None:
        out = out * mask[None, :, None]
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]
    y = yield from row_sum(blk, y)
    return y, cache


def attn_decode(p, cfg, x1, cache, pos, window):
    """One-token decode off any mesh (:func:`attn_decode_body` run
    locally); returns (y, cache), the cache written in place."""
    return C.run_local(attn_decode_body(p, cfg, x1, cache, pos, window))


# ===========================================================================
# MLP (SwiGLU or 2-matrix GELU)
# ===========================================================================

def mlp_init(cfg: ModelConfig, gen: torch.Generator, lead=(), device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    p = {
        "w_up": init_dense(gen, lead + (d, f), d, cfg.dtype, device),
        "w_down": init_dense(gen, lead + (f, d), f, cfg.dtype, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = init_dense(gen, lead + (d, f), d, cfg.dtype, device)
    return p


def mlp_axes(cfg: ModelConfig) -> dict:
    ax = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.mlp_gated:
        ax["w_gate"] = ("embed", "mlp")
    return ax


def mlp_apply(p: dict, x: torch.Tensor, ln=None, eps: float = 1e-5
              ) -> torch.Tensor:
    """On a rank's columns of ``w_up`` / ``w_gate`` and rows of
    ``w_down``, its partial output; with ``ln``, of the RMS norm of x."""
    if ln is not None:
        x = rms_norm(ln, x, eps)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]


def mlp_body(p: dict, cfg: ModelConfig, x: torch.Tensor, ln=None):
    """Rank body step: :func:`mlp_apply` of the norm (scale ``ln``) of
    ``x`` and, where the rank holds a slice of the FFN dim, its inputs
    through ``model_copy`` and the sum over the model axis."""
    split = p["w_down"].shape[-2] != cfg.d_ff
    if split:
        x = yield from acts.model_copy(x)
        if ln is not None:
            ln = yield from acts.model_copy(ln)
    y = piece(cfg, mlp_apply, p, x, ln, cfg.norm_eps)
    if split:
        y = yield from acts.model_sum(y)
    return y


# ===========================================================================
# MoE (token-choice top-k, static capacity, gather/scatter dispatch)
# ===========================================================================

def moe_init(cfg: ModelConfig, gen: torch.Generator, lead=(), device=None) -> dict:
    """The router stays float32 whatever the model dtype."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = tuple(lead)
    return {
        "router": init_dense(gen, lead + (d, e), d, torch.float32, device),
        "w_gate": init_dense(gen, lead + (e, d, f), d, cfg.dtype, device),
        "w_up": init_dense(gen, lead + (e, d, f), d, cfg.dtype, device),
        "w_down": init_dense(gen, lead + (e, f, d), f, cfg.dtype, device),
    }


def moe_axes(cfg: ModelConfig) -> dict:
    return {"router": ("embed", None),
            "w_gate": ("expert", "embed", "expert_mlp"),
            "w_up": ("expert", "embed", "expert_mlp"),
            "w_down": ("expert", "expert_mlp", "embed")}


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    ideal = n_tokens * cfg.n_experts_active / cfg.n_experts
    return max(1, int(np.ceil(ideal * cfg.expert_capacity_factor)))


def moe_route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The router: (probs (B,S,E) float32, top_p (B,S,k) renormalized,
    top_e (B,S,k) int64), the top k in ``lax.top_k``'s order."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = topk_stable(probs, cfg.n_experts_active)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def moe_dispatch(cfg: ModelConfig, top_e: torch.Tensor, s: int):
    """Per-row dispatch of the (B, S*k) assignments, in the reference's
    sorted order: (order, sorted expert, keep, destination row of the
    (E*cap + 1)-row buffer, whose last row takes every dropped
    assignment). The sort is stable, so a full expert drops the last
    tokens of its run, as ``jnp.argsort`` does."""
    b, e = top_e.shape[0], cfg.n_experts
    cap = moe_capacity(cfg, s)
    sk = s * cfg.n_experts_active
    flat_e = top_e.reshape(b, sk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first_of_run = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(sk, device=top_e.device)[None] - first_of_run
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    return order, keep, dest, cap


def _moe_combine_f32(h, dest, keep, order, top_p, x_dtype, n_slots, s, k):
    """Each token's k contributions gathered back from the expert rows in
    the assignments' own order (token t's are t*k .. t*k + k - 1) and
    summed in float32 in that order: (B, S, D) float32."""
    b, sk = order.shape
    d = h.shape[-1]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(sk, device=order.device).expand(b, -1))
    dest_t = torch.gather(dest, 1, inv).clamp(max=n_slots - 1)     # "clip"
    keep_t = torch.gather(keep, 1, inv)
    gathered = torch.gather(h, 1, dest_t[..., None].expand(-1, -1, d))
    gate = (top_p.reshape(b, sk) * keep_t).to(x_dtype)
    return (gathered * gate[..., None]).reshape(b, s, k, d).float().sum(2)


def _expert_ffn(buf, w_gate, w_up, w_down):
    h = F.silu(torch.einsum("becd,edf->becf", buf, w_gate)) \
        * torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", h, w_down)


def _balance_aux(probs, top_e, e):
    """Switch-style load-balance loss of the rows given."""
    return C.run_local(_balance_aux_body(probs, top_e, e))


def _balance_aux_body(probs, top_e, e):
    """Rank body step: the Switch-style load-balance loss of the whole
    batch, its router means taken over the batch axes of a training rank
    body (``act_sharding.batch_mean``), of the rows given elsewhere."""
    me = probs.mean(dim=(0, 1))
    ce = (top_e[..., :1] == torch.arange(e, device=probs.device)).float().mean(
        dim=(0, 1))                                     # one-hot of the top pick
    me = yield from acts.batch_mean(me)
    ce = yield from acts.batch_mean(ce)
    return e * torch.sum(me * ce)


def _enter(axis, t: torch.Tensor):
    """Rank body step: ``t`` into the rank's part of the MoE through the
    model axis's copy (its backward summing in float32) where it carries
    gradient (``axis`` None: as is)."""
    if axis is None or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    out = yield C.model_copy(axis, t.float())
    return out.to(t.dtype)


def moe_ep_body(ctx: C.RankContext, cfg: ModelConfig, router, w_gate, w_up,
                w_down, xl, tp_axis: str, batch_axes: tuple,
                replicated: bool = False):
    """One rank of the expert-parallel MoE (the reference's ``shard_map``
    body): every rank routes all of its rows' tokens, fills capacity only
    from its own E/TP experts (non-local assignments sort to the end and
    never enter capacity), runs those experts' FFN, and ONE sum over the
    model axis combines the float32 partial outputs. ``aux`` is this
    shard's balance loss averaged over the batch axes. ``replicated``
    (a tensor-parallel rank body): the tokens and their gate weights
    enter the rank's experts through the model axis's copy and the
    combine is a sum into a replicated value (Megatron's pair), and
    ``aux`` is the whole batch's (:func:`_balance_aux_body`)."""
    rank = ctx.index[tp_axis]
    e, k = cfg.n_experts, cfg.n_experts_active
    e_loc = e // ctx.size[tp_axis]
    b, s, d = xl.shape
    cap = moe_capacity(cfg, s)
    sk = s * k
    probs, top_p, top_e = moe_route({"router": router}, cfg, xl)
    if replicated:
        aux = yield from _balance_aux_body(probs, top_e, e)
        xl = yield from _enter(tp_axis, xl)
        top_p = yield from _enter(tp_axis, top_p)
    else:
        aux = _balance_aux(probs, top_e, e)

    flat_e = top_e.reshape(b, sk)
    is_local = torch.div(flat_e, e_loc, rounding_mode="floor") == rank
    sort_key = torch.where(is_local, flat_e, e)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    sorted_e = torch.gather(sort_key, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(sk, device=xl.device)[None] - first
    keep = (pos_in_e < cap) & (sorted_e < e)
    e_rel = torch.where(keep, sorted_e - rank * e_loc, 0)
    # dropped / non-local assignments go to a TRASH row, never to slot 0
    dest = torch.where(keep, e_rel * cap + pos_in_e, e_loc * cap)
    token_of = order // k
    src = torch.gather(xl, 1, token_of[..., None].expand(-1, -1, d)) \
        * keep[..., None].to(xl.dtype)
    buf = torch.zeros((b, e_loc * cap + 1, d), dtype=xl.dtype, device=xl.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), src)
    h = piece(cfg, _expert_ffn, buf[:, :-1].reshape(b, e_loc, cap, d), w_gate,
              w_up, w_down).reshape(b, e_loc * cap, d)
    partial = _moe_combine_f32(h, dest, keep, order, top_p, xl.dtype,
                               e_loc * cap, s, k)
    out = yield (C.row_sum if replicated else C.psum)(tp_axis, partial)
    if batch_axes:
        # per-shard balance loss, averaged — the standard EP choice (a
        # global mean would need an extra reduction of the full probs)
        aux = yield C.pmean(batch_axes, aux)
    return out.to(xl.dtype), aux


def moe_apply_ep(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Expert parallelism over the active policy's model axis.

    On an ``InProcessMesh`` ``x`` is the global (B, S, D) batch: its rows
    split over the batch axes (replicated when they do not divide B), the
    experts over the model axis, every rank runs in turn and the global
    (out, aux) returns. On a ``DeviceMesh`` ``x`` is this rank's rows and
    the weights are full or this rank's expert shards (DTensors laid out
    on the expert dim); this rank's (out, aux) returns. Both carry
    gradient: the combine's sum over the model axis passes each rank the
    axis's sum of the output's gradients."""
    pol = acts.current_policy()
    mesh, tp_axis = pol["mesh"], pol["model"]
    sizes = C.mesh_shape(mesh)
    batch = pol["batch"]
    batch_axes = () if batch is None else (
        tuple(batch) if isinstance(batch, (tuple, list)) else (batch,))
    e = cfg.n_experts
    e_loc = e // sizes[tp_axis]
    weights = [p["w_gate"], p["w_up"], p["w_down"]]
    if isinstance(mesh, C.InProcessMesh):
        n_dp = 1
        for a in batch_axes:
            n_dp *= sizes[a]
        if x.shape[0] % n_dp != 0:
            batch_axes = ()                           # replicate odd batches
        bspec = (batch_axes if len(batch_axes) != 1 else batch_axes[0]) \
            if batch_axes else None
        x_spec = (bspec, None, None)

        def make(rank, ctx):
            r = ctx.index[tp_axis]
            mine = [w[r * e_loc:(r + 1) * e_loc] for w in weights]
            xl = x[C.local_slices(x_spec, x.shape, sizes, ctx.index)]
            return moe_ep_body(ctx, cfg, p["router"], *mine, xl, tp_axis,
                               batch_axes)

        outs = C.run_in_process(make, mesh)
        out = C.assemble({r: o[0] for r, o in enumerate(outs)}, x_spec,
                         x.shape, mesh)
        return out, outs[0][1]
    from torch.distributed.tensor import DTensor
    ctx = C.rank_context(mesh)
    r = ctx.index[tp_axis]
    mine = [w.to_local() if isinstance(w, DTensor)
            else w[r * e_loc:(r + 1) * e_loc] for w in weights]
    router = p["router"].full_tensor() if isinstance(p["router"], DTensor) \
        else p["router"]
    return C.run_spmd(moe_ep_body(ctx, cfg, router, *mine, x, tp_axis,
                                  batch_axes), mesh)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B,S,D) -> (out (B,S,D), aux_loss). Dropped-token capacity MoE,
    dispatched per batch row; capacity per (row, expert) is
    ceil(S*k/E * cf)."""
    tp = acts.model_axis_size()
    if tp > 1 and cfg.n_experts % tp == 0:
        return moe_apply_ep(p, cfg, x)                   # explicit EP
    out, aux_loss = _moe_local(p, cfg, x)
    return out.to(x.dtype), aux_loss


def moe_body(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Rank body step of the MoE under the tensor-parallel context: the
    expert-parallel body where the rank holds a shard of the experts;
    every expert on the rank's slice of the expert FFN dim, then the sum
    over the model axis, where it holds such a slice; else (and off a
    mesh) :func:`moe_apply`."""
    tp = acts.tensor_parallel_context()
    if tp is not None and p["w_gate"].shape[0] != cfg.n_experts:
        out, aux = yield from moe_ep_body(tp.rank, cfg, p["router"],
                                          p["w_gate"], p["w_up"],
                                          p["w_down"], x, tp.axis, (), True)
        return out, aux
    if p["w_gate"].shape[-1] != cfg.d_ff:
        out, aux = yield from _moe_local_body(p, cfg, x, tp.axis)
        out = yield from acts.model_sum(out)
        return out.to(x.dtype), aux
    if acts.model_axis_size() > 1:
        return moe_apply(p, cfg, x)                      # the policy's EP
    out, aux = yield from _moe_local_body(p, cfg, x, None)
    return out.to(x.dtype), aux


def _moe_local(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Every expert of ``p`` on every token of ``x``: (out (B,S,D)
    float32, aux_loss); on a slice of the expert FFN dim, the partial
    output."""
    return C.run_local(_moe_local_body(p, cfg, x, None))


def _moe_local_body(p: dict, cfg: ModelConfig, x: torch.Tensor, axis):
    """Rank body step of :func:`_moe_local`: on a slice of the expert FFN
    dim of the model axis ``axis``, the tokens and their gate weights
    enter through the axis's copy (``axis`` None: off the axis); the
    balance loss is :func:`_balance_aux_body`'s."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    probs, top_p, top_e = moe_route(p, cfg, x)
    aux_loss = yield from _balance_aux_body(probs, top_e, e)
    x = yield from _enter(axis, x)
    top_p = yield from _enter(axis, top_p)

    order, keep, dest, cap = moe_dispatch(cfg, top_e, s)
    token_of = order // k                                           # (B, S*k)
    src = torch.gather(x, 1, token_of[..., None].expand(-1, -1, d)) \
        * keep[..., None].to(x.dtype)
    # kept destinations are distinct; dropped ones all land in the last
    # row, which is cut off whichever write wins there
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), src)
    h = piece(cfg, _expert_ffn, buf[:, :-1].reshape(b, e, cap, d), p["w_gate"],
              p["w_up"], p["w_down"]).reshape(b, e * cap, d)
    return _moe_combine_f32(h, dest, keep, order, top_p, x.dtype, e * cap,
                            s, k), aux_loss


# ===========================================================================
# Mamba2 SSD mixer (state-space duality, chunked)
# ===========================================================================

def ssd_init(cfg: ModelConfig, gen: torch.Generator, lead=(), device=None) -> dict:
    """``a_log``, ``d_skip`` and ``dt_bias`` stay float32 whatever the
    model dtype."""
    d, di, n, hs = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n                                           # x, B, C (G=1)
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.from_numpy(np.log(np.linspace(1.0, 16.0, hs)).astype(np.float32))
    return {
        "in_z": init_dense(gen, lead + (d, di), d, cfg.dtype, device),
        "in_xbc": init_dense(gen, lead + (d, conv_dim), d, cfg.dtype, device),
        "in_dt": init_dense(gen, lead + (d, hs), d, cfg.dtype, device),
        "conv_w": init_dense(gen, lead + (cfg.ssm_conv, conv_dim), cfg.ssm_conv,
                             cfg.dtype, device),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=cfg.dtype, device=device),
        "a_log": a_log.to(device).expand(lead + (hs,)).contiguous(),
        "d_skip": torch.ones(lead + (hs,), **f32),
        "dt_bias": torch.zeros(lead + (hs,), **f32),
        "norm": torch.ones(lead + (di,), dtype=cfg.dtype, device=device),
        "out_proj": init_dense(gen, lead + (di, d), di, cfg.dtype, device),
    }


def ssd_axes(cfg: ModelConfig) -> dict:
    return {"in_z": ("embed", "mlp"), "in_xbc": ("embed", "mlp"),
            "in_dt": ("embed", None), "conv_w": ("conv", "mlp"),
            "conv_b": ("mlp",), "a_log": (None,), "d_skip": (None,),
            "dt_bias": (None,), "norm": ("mlp",), "out_proj": ("mlp", "embed")}


def _project_zxbcdt(p, x):
    return x @ p["in_z"], x @ p["in_xbc"], x @ p["in_dt"]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. xbc (B,S,C); w (K,C); ``prefix`` (B,K-1,C)
    the rows before xbc's first (zeros where None)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)) if prefix is None \
        else torch.cat([prefix.to(xbc.dtype), xbc], dim=1)
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def _ssd_chunked(xs, b_in, c_in, dt, a_log, chunk: int, init_state=None):
    """SSD core, float32. xs (B,S,H,P); b_in/c_in (B,S,N) (G=1); dt
    (B,S,H) (post-softplus). Returns (y (B,S,H,P), final_state
    (B,H,N,P)). Each of the reference's three-operand einsums is two
    contractions here, and none builds a (Q, K, H, P) tensor."""
    bsz, s_orig, h, pdim = xs.shape
    n = b_in.shape[-1]
    q = min(chunk, s_orig)
    pad = (-s_orig) % q
    if pad:        # causal: end-padding never influences the returned prefix
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q
    a = -torch.exp(a_log)                                           # (H,)
    da = (a[None, None] * dt).reshape(bsz, nc, q, h)                # log-decay
    xbar = (xs * dt[..., None]).reshape(bsz, nc, q, h, pdim)
    bc = b_in.reshape(bsz, nc, q, n)
    cc = c_in.reshape(bsz, nc, q, n)

    cum = torch.cumsum(da, dim=2)                                   # (B,nc,Q,H)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for j<=i. Mask in LOG space
    # (before exp): masking after exp leaks NaN into the gradients.
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xs.device))
    l_mat = torch.exp(torch.where(tri[None, None, ..., None], li, -1e30))
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)                    # (B,nc,Q,K)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * l_mat, xbar)

    # chunk summary states: S_c = sum_k exp(cum_end - cum_k) * B_k (x) xbar_k
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    states = torch.einsum("bckn,bckhp->bchnp", bc,
                          decay_to_end[..., None] * xbar)

    # inter-chunk recurrence: the state BEFORE each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                       # (B,nc,H)
    r = torch.zeros((bsz, h, n, pdim), dtype=torch.float32, device=xs.device) \
        if init_state is None else init_state.float()
    r_prev = []
    for c in range(nc):
        r_prev.append(r)
        r = r * chunk_decay[:, c, :, None, None] + states[:, c]
    r_prev = torch.stack(r_prev, dim=1)                             # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cc, r_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, pdim)[:, :s_orig]
    return y, r


def ssd_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                init_state=None, return_state: bool = False):
    """Full-sequence Mamba2 mixer. x (B,S,D) -> (B,S,D); with
    ``return_state`` also {"ssm": (B,H,N,P), "conv": (B,K-1,C)} float32,
    the decode caches after the last token."""
    di, n, hs, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt = _project_zxbcdt(p, x)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(*x.shape[:2], hs, pdim)
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    y, final = _ssd_chunked(xs.float(), b_in.float(), c_in.float(), dt,
                            p["a_log"], cfg.ssm_chunk, init_state)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        # the decode conv cache holds the last K-1 PRE-activation xBC inputs
        kc = cfg.ssm_conv - 1
        tail = F.pad(xbc_raw, (0, 0, kc, 0))[:, -kc:]
        return out, {"ssm": final.float(), "conv": tail.float()}
    return out


def ssd_cache_init(cfg: ModelConfig, batch: int, lead=(), device=None) -> dict:
    di, n = cfg.d_inner, cfg.ssm_state
    lead = tuple(lead)
    return {
        "ssm": torch.zeros(lead + (batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=torch.float32, device=device),
    }


def ssd_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """:func:`ssd_forward` over the prompt, its end states written into
    ``cache``'s ``ssm`` and ``conv`` in place; returns (y, cache)."""
    y, state = ssd_forward(p, cfg, x, return_state=True)
    cache["ssm"].copy_(state["ssm"])
    cache["conv"].copy_(state["conv"])
    return y, cache


def _ssd_in(p, cfg, x, ln):
    """The norm (``ln``) and the input projections of ``x``'s rows."""
    return _project_zxbcdt(p, prenorm(ln, cfg, x))


def _ssd_local_scan(p, cfg, xbc_raw, prefix, dt):
    """The conv (``prefix``: the rows before the rank's first), then the
    chunked scan of the rank's rows from a zero state: (y, xs, C, the
    cumulative log-decay from the rank's first row (B,R,H), the final
    state (B,H,N,P) and the span's total log-decay (B,H)), float32."""
    di, n, hs, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"], prefix))
    xs = xbc[..., :di].reshape(*xbc.shape[:2], hs, pdim)
    b_in = xbc[..., di:di + n].float()
    c_in = xbc[..., di + n:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])
    y, final = _ssd_chunked(xs.float(), b_in, c_in, dt, p["a_log"],
                            cfg.ssm_chunk)
    cum = torch.cumsum(-torch.exp(p["a_log"])[None, None] * dt, dim=1)
    return y, xs, c_in, cum, final, cum[:, -1]


def _ssd_out(p, cfg, x, z, y, xs, c_in, cum, s_in):
    """The incoming state's term C_t . exp(cum_t) . s_in added to the
    rank's scan, the skip, the gated norm and ``out_proj``."""
    di = cfg.d_inner
    y = y + torch.einsum("bsn,bhnp->bshp", c_in, s_in) \
        * torch.exp(cum)[..., None]
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]


def _combine_states(states, upto: int):
    """The state entering rank ``upto`` of a split: the ranks' (final
    state, total log-decay) before it folded in rank order, float32
    (``s = s * exp(total_j) + final_j``); zeros for rank 0 (read from the
    gathered states times 0, as the tails in :func:`ssd_split_body`)."""
    s = states[0][0] * 0
    for final, total in states[:upto]:
        s = s * torch.exp(total)[..., None, None] + final
    return s


def ssd_split_body(p: dict, cfg: ModelConfig, x: torch.Tensor, ln, split,
                   cache: dict | None = None):
    """Rank body step: the SSD mixer of the rank's rows of a sequence
    split (``act_sharding.seq_split``), over the norm (scale ``ln``) of
    ``x``. No rank computes the mixer whole:

    * the causal conv takes the previous rank's last ``ssm_conv - 1``
      pre-activation rows from an all-gather of every rank's tail
      (rank 0: zeros);
    * each rank scans its rows from a zero state; the ranks' final
      states and total log-decays, (B, H, N, P) and (B, H) float32, are
      gathered in one all-gather, and each rank folds those of the ranks
      before it, in rank order, into its incoming state
      (:func:`_combine_states`);
    * the incoming state's term, linear in it, is added to the rank's
      outputs (:func:`_ssd_out`).

    The rank asks for its tail rows and its state, never the sequence.
    Both gathers carry gradient (backward: the group's summed
    cotangents), so three remat pieces lie between them. With ``cache``
    (prefill) every rank writes the last rank's final state (all ranks
    folded) and the last ``ssm_conv - 1`` rows of the sequence."""
    kc = cfg.ssm_conv - 1
    z, xbc_raw, dt = piece(cfg, _ssd_in, p, cfg, x, ln)
    if xbc_raw.shape[1] < kc:
        raise ValueError(f"{cfg.name}: a rank's {xbc_raw.shape[1]} rows are "
                         f"fewer than the conv's {kc}-row tail")
    tails = yield from acts.seq_gather(split, xbc_raw[:, -kc:])
    # rank 0's zeros read the gathered tails too (times 0), so that every
    # rank's backward runs the gathers' reduce-scatters (on a process
    # group a rank whose graph skipped one would desert the collective)
    prefix = tails[:, :kc] * 0 if split.index == 0 \
        else tails[:, (split.index - 1) * kc:split.index * kc]
    y, xs, c_in, cum, final, total = piece(cfg, _ssd_local_scan, p, cfg,
                                           xbc_raw, prefix, dt)
    b, h, n, pdim = final.shape
    packed = torch.cat([final.reshape(b, h, n * pdim), total[..., None]], -1)
    every = yield from acts.seq_gather(split, packed[None], 0)
    states = [(r[..., :-1].reshape(b, h, n, pdim), r[..., -1])
              for r in every.unbind(0)]
    s_in = _combine_states(states, split.index)
    out = piece(cfg, _ssd_out, p, cfg, x, z, y, xs, c_in, cum, s_in)
    if cache is not None:
        cache["ssm"].copy_(_combine_states(states, split.size))
        cache["conv"].copy_(tails[:, -kc:].float())
    return out


def ssd_prefill_body(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict):
    """Rank body step of :func:`ssd_prefill` (x already normed): under a
    sequence split :func:`ssd_split_body`, else the whole mixer."""
    split = acts.seq_split_context()
    if split is None:
        return ssd_prefill(p, cfg, x, cache)
    y = yield from ssd_split_body(p, cfg, x, None, split, cache)
    return y, cache


def ssd_decode(p: dict, cfg: ModelConfig, x1: torch.Tensor, cache: dict):
    """Single-token recurrent step. x1 (B,1,D); ``cache``'s ``ssm`` and
    ``conv`` are written in place; returns (y, cache)."""
    di, n, hs, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _project_zxbcdt(p, x1)                             # (B,1,*)
    window = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None]                                # (B,1,C)
    xs = xbc1[..., :di].reshape(-1, hs, pdim).float()               # (B,H,P)
    b_in = xbc1[:, 0, di:di + n].float()                            # (B,N)
    c_in = xbc1[:, 0, di + n:].float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])               # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(a[None] * dt1)                                # (B,H)
    xbar = xs * dt1[..., None]                                      # (B,H,P)
    state = cache["ssm"] * decay[..., None, None] \
        + torch.einsum("bn,bhp->bhnp", b_in, xbar)
    y = torch.einsum("bn,bhnp->bhp", c_in, state) \
        + p["d_skip"][None, :, None] * xs
    y = y.reshape(-1, 1, di).to(x1.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    cache["ssm"].copy_(state)
    cache["conv"].copy_(window[:, 1:].float())
    return y @ p["out_proj"], cache
