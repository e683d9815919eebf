"""Encoder-decoder backbone, Whisper family (port of
``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the reference: callers pass
precomputed frame embeddings (B, enc_seq_len, D). The encoder is a
non-causal transformer; the decoder adds cross-attention to the encoder
memory. Stacked params and caches as in ``models/decoder.py``, the
reference's ``lax.scan`` a loop over the layer index, and the cache
written in place. With ``cfg.remat`` and grad on, each encoder and
decoder layer of the training forward is one checkpointed region (the
reference's ``nothing_saveable`` policy, whatever ``remat_policy``
says). The decoder's self-attention decode goes through
``layers.attn_decode``, so through the flash-decode kernel K5 on the
card; the cross-attention over the memory stays plain, as in the
reference. The serving paths are rank bodies (:func:`prefill_body`,
:func:`decode_body`, as in ``models/decoder.py``): under
``act_sharding.tensor_parallel`` the encoder's and the decoder's
attention, the cross-attention and the MLPs compute on the rank's heads
and FFN slice and sum over the model axis, and ``mem_k`` / ``mem_v``
hold the rank's KV heads. :func:`forward_body` is the training forward
as a rank body. Under a sequence split (``act_sharding.seq_split``, the
pure-DP ``--opt`` cells) the decoder computes the rank's token rows and
the encoder the rank's frames where their count divides the model axis
(else all of them, on every rank, as the reference's ``_constrain``
leaves a stream that does not divide)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.bridge import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, init_dense, rms_norm
from repro_torch.models.decoder import (_positions, embed_lookup,
                                        head_logits, last_row, layer_slice,
                                        remat, remat_active)


# --- encoder ---------------------------------------------------------------

def _enc_layer_init(cfg, gen, lead, device):
    ones = lambda: torch.ones(tuple(lead) + (cfg.d_model,), dtype=cfg.dtype,
                              device=device)
    return {"ln1": ones(), "attn": L.attn_init(cfg, gen, lead, device),
            "ln2": ones(), "mlp": L.mlp_init(cfg, gen, lead, device)}


def _enc_layer_axes(cfg):
    return {"ln1": (None,), "attn": L.attn_axes(cfg),
            "ln2": (None,), "mlp": L.mlp_axes(cfg)}


def _softmax_attn(cfg, blk, q, k, v):
    """Unmasked attention: q (B,Sq,Hq,Dh) of the heads of ``blk``, k/v
    (B,Sk,Hkv,Dh) the stored KV heads."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, L._kv_for_q(cfg, k, blk)
                          ).float() / math.sqrt(cfg.dh)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, L._kv_for_q(cfg, v, blk))


def _enc_attn_core(p, cfg, x, positions, blk, ln):
    q, k, v = L._project_qkv(p, cfg, L.prenorm(ln, cfg, x), positions[None])
    return _enc_attend_out(p, cfg, q, k, v, blk)


def _enc_attend_out(p, cfg, q, k, v, blk):
    return torch.einsum("bshk,hkd->bsd", _softmax_attn(cfg, blk, q, k, v),
                        p["wo"])


def _enc_layer_body(p, cfg, x, positions, split=None):
    """Rank body step of one encoder layer; under ``split`` (the frames'
    sequence split) the rank's frames attend over K / V gathered over the
    split's axis."""
    blk = L.head_block(cfg, p["attn"])
    if split is not None:
        L._check_split_heads(cfg, blk)
        q, k, v = L.piece(cfg, L._qkv_core, p["attn"], cfg, x, positions,
                          p["ln1"])
        k = yield from acts.seq_gather(split, k)
        v = yield from acts.seq_gather(split, v)
        x = x + L.piece(cfg, _enc_attend_out, p["attn"], cfg, q, k, v, blk)
        return x + (yield from L.mlp_body(p["mlp"], cfg, x, p["ln2"]))
    pa, xa, ln = yield from L.enter_heads(p["attn"], cfg, x, blk, p["ln1"])
    x = x + (yield from L.row_sum(blk, L.piece(cfg, _enc_attn_core, pa, cfg,
                                                xa, positions, blk, ln)))
    return x + (yield from L.mlp_body(p["mlp"], cfg, x, p["ln2"]))


def _enc_layer_fwd(p, cfg, x, positions):
    return C.run_local(_enc_layer_body(p, cfg, x, positions))


# --- decoder with cross-attention ------------------------------------------

def _dec_layer_init(cfg, gen, lead, device):
    ones = lambda: torch.ones(tuple(lead) + (cfg.d_model,), dtype=cfg.dtype,
                              device=device)
    return {"ln1": ones(), "attn": L.attn_init(cfg, gen, lead, device),
            "lnx": ones(), "xattn": L.attn_init(cfg, gen, lead, device),
            "ln2": ones(), "mlp": L.mlp_init(cfg, gen, lead, device)}


def _dec_layer_axes(cfg):
    return {"ln1": (None,), "attn": L.attn_axes(cfg),
            "lnx": (None,), "xattn": L.attn_axes(cfg),
            "ln2": (None,), "mlp": L.mlp_axes(cfg)}


def _cross_attn(p, cfg, h, mem_k, mem_v):
    """Rank body step. h (B,Sq,D); mem_k/v (B,Sm,Hkv,Dh) precomputed
    from the memory."""
    blk = L.head_block(cfg, p)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    out = _softmax_attn(cfg, blk, q, mem_k, mem_v)
    return (yield from L.row_sum(blk, torch.einsum("bshk,hkd->bsd", out,
                                                   p["wo"])))


def _xattn_core(p, cfg, h, mem, blk, ln):
    return _xattn_kv_core(p, cfg, h, *_mem_kv(p, mem), blk, ln)


def _xattn_kv_core(p, cfg, h, mem_k, mem_v, blk, ln):
    q = torch.einsum("bsd,dhk->bshk", L.prenorm(ln, cfg, h), p["wq"])
    out = _softmax_attn(cfg, blk, q, mem_k, mem_v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _mem_kv_body(p, mem, msplit):
    """Rank body step: the cross-attention's K / V of the memory, those of
    the rank's frames gathered over the split's axis where the frames are
    split (``msplit``)."""
    mk, mv = _mem_kv(p, mem)
    if msplit is not None:
        mk = yield from acts.seq_gather(msplit, mk)
        mv = yield from acts.seq_gather(msplit, mv)
    return mk, mv


def _cross_attn_body(p, cfg, h, mem, ln, msplit=None):
    """Rank body step of the training forward's cross-attention over the
    norm (scale ``ln``) of ``h``: the KV projections of the encoder memory
    computed here, ``h``, ``ln`` and ``mem`` entering the rank's heads
    through the model axis's copy. Under a sequence split of the frames
    (``msplit``) the rank's frames' K / V are gathered; ``h`` holds the
    rank's token rows (or all of them) either way."""
    blk = L.head_block(cfg, p)
    if msplit is not None:
        L._check_split_heads(cfg, blk)
        mk, mv = yield from _mem_kv_body(p, mem, msplit)
        return L.piece(cfg, _xattn_kv_core, p, cfg, h, mk, mv, blk, ln)
    p, h, ln = yield from L.enter_heads(p, cfg, h, blk, ln)
    if blk.split:
        mem = yield from acts.model_copy(mem)
    return (yield from L.row_sum(blk, L.piece(cfg, _xattn_core, p, cfg, h,
                                              mem, blk, ln)))


def _dec_layer_body(lp, cfg, h, positions, mem, msplit=None):
    """Rank body step of one decoder layer of the training forward."""
    h = h + (yield from L.attn_body(lp["attn"], cfg, h, positions, 0,
                                    lp["ln1"]))
    h = h + (yield from _cross_attn_body(lp["xattn"], cfg, h, mem, lp["lnx"],
                                         msplit))
    return h + (yield from L.mlp_body(lp["mlp"], cfg, h, lp["ln2"]))


def _mem_kv(p, mem):
    return (torch.einsum("bsd,dhk->bshk", mem, p["wk"]),
            torch.einsum("bsd,dhk->bshk", mem, p["wv"]))


def _dec_tail(lp, cfg, h, mem_k, mem_v):
    """Rank body step: cross-attention and the MLP after the
    self-attention."""
    hx = rms_norm(lp["lnx"], h, cfg.norm_eps)
    h = h + (yield from _cross_attn(lp["xattn"], cfg, hx, mem_k, mem_v))
    return h + (yield from L.mlp_body(lp["mlp"], cfg, h, lp["ln2"]))


def _dec_layer_fwd(lp, cfg, h, positions, mem):
    """One decoder layer of the teacher-forced forward."""
    hh = rms_norm(lp["ln1"], h, cfg.norm_eps)
    h = h + L.attn_forward(lp["attn"], cfg, hh, positions, 0)
    return C.run_local(_dec_tail(lp, cfg, h, *_mem_kv(lp["xattn"], mem)))


# --- full model --------------------------------------------------------------

def init_encdec(cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda") -> dict:
    """Random params on ``device`` from ``gen`` (default: a CPU generator
    seeded 0), as ``decoder.init_decoder`` draws them."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    d = cfg.d_model
    return {
        "embed": init_dense(gen, (cfg.vocab_size, d), d, cfg.dtype, dev),
        "enc_layers": _enc_layer_init(cfg, gen, (cfg.n_enc_layers,), dev),
        "enc_norm": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "dec_layers": _dec_layer_init(cfg, gen, (cfg.n_layers,), dev),
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "head": init_dense(gen, (d, cfg.vocab_size), d, cfg.dtype, dev),
    }


def encdec_axes(cfg: ModelConfig) -> dict:
    """Logical sharding axes of :func:`init_encdec`'s params."""
    from repro_torch.models.decoder import _stack_axes
    return {
        "embed": ("vocab", "embed"),
        "enc_layers": _stack_axes(_enc_layer_axes(cfg)),
        "enc_norm": (None,),
        "dec_layers": _stack_axes(_dec_layer_axes(cfg)),
        "final_norm": (None,),
        "head": ("embed", "vocab"),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) stub frontend embeddings -> encoder memory."""
    positions = torch.arange(frames.shape[1], dtype=torch.int32,
                             device=frames.device)
    x = frames
    run = (lambda *a: remat(_enc_layer_fwd, *a)) if remat_active(cfg) \
        else _enc_layer_fwd
    for i in range(cfg.n_enc_layers):
        x = run(layer_slice(params["enc_layers"], i), cfg, x, positions)
    return rms_norm(params["enc_norm"], x, cfg.norm_eps)


def _encode_body(params, cfg: ModelConfig, frames: torch.Tensor):
    """Rank body of :func:`encode`: (memory, its split). Under a policy
    that splits the sequence (``act_sharding.stream_split``) the frames
    split over the model axis where their count divides it, and the
    memory returned is the rank's frames; else every rank encodes them
    all, as the reference's ``_constrain`` drops a split that does not
    divide (whisper-tiny's 1,500 frames on 16)."""
    msplit = acts.stream_split(frames.shape[1])
    x = frames if msplit is None else msplit.cut(frames)
    first = 0 if msplit is None else msplit.start
    positions = torch.arange(first, first + x.shape[1], dtype=torch.int32,
                             device=frames.device)
    for i in range(cfg.n_enc_layers):
        x = yield from _enc_layer_body(layer_slice(params["enc_layers"], i),
                                       cfg, x, positions, msplit)
    return rms_norm(params["enc_norm"], x, cfg.norm_eps), msplit


def forward(params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor):
    """Teacher-forced training forward. Returns (logits (B,S,V), aux=0)."""
    mem = encode(params, cfg, frames)
    h = params["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=h.device)
    run = (lambda *a: remat(_dec_layer_fwd, *a)) if remat_active(cfg) \
        else _dec_layer_fwd
    for i in range(cfg.n_layers):
        h = run(layer_slice(params["dec_layers"], i), cfg, h, positions, mem)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return h @ params["head"], torch.zeros((), dtype=torch.float32,
                                           device=h.device)


def forward_body(params, cfg: ModelConfig, frames: torch.Tensor,
                 tokens: torch.Tensor):
    """Rank body of :func:`forward` for training (``decoder.forward_body``
    says how it splits over the model axis and how remat maps onto its
    local pieces). Returns (the rank's columns of the logits, aux=0).
    Under a sequence split ``tokens`` are the rank's rows (positions from
    its first) and the frames split where their count divides the axis
    (:func:`_encode_body`)."""
    with L.remat_pieces(remat_active(cfg)):
        mem, msplit = yield from _encode_body(params, cfg, frames)
        h = yield from embed_lookup(params["embed"], cfg, tokens)
        positions = _positions(h)
        for i in range(cfg.n_layers):
            h = yield from _dec_layer_body(layer_slice(params["dec_layers"], i),
                                           cfg, h, positions, mem, msplit)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return (yield from head_logits(params, cfg, h)), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """Stacked cache: the decoder's self-attention ring buffer and the
    cross-attention's ``mem_k`` / ``mem_v``."""
    dev, lead = resolve_device(device), (cfg.n_layers,)
    cache = L.attn_cache_init(cfg, batch, cache_len, lead, dev)
    shape = lead + (batch, cfg.enc_seq_len, cfg.n_kv_heads, cfg.dh)
    cache["mem_k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    cache["mem_v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return cache


def prefill_body(params, cfg: ModelConfig, cache: dict, frames: torch.Tensor,
                 tokens: torch.Tensor):
    """Rank body of :func:`prefill`; under a sequence split as
    ``decoder.prefill_body`` (every rank writes the whole caches) and
    :func:`forward_body` (the frames)."""
    mem, msplit = yield from _encode_body(params, cfg, frames)
    h = yield from embed_lookup(params["embed"], cfg, tokens)
    positions = _positions(h)
    for i in range(cfg.n_layers):
        lp, lc = layer_slice(params["dec_layers"], i), layer_slice(cache, i)
        hh = rms_norm(lp["ln1"], h, cfg.norm_eps)
        y, lc = yield from L.attn_prefill_body(lp["attn"], cfg, hh, positions,
                                               lc, 0)
        h = h + y
        mk, mv = yield from _mem_kv_body(lp["xattn"], mem, msplit)
        split = acts.seq_split_context()
        for name, kv in (("mem_k", mk), ("mem_v", mv)):
            lc[name].copy_(kv if split is None
                           else L.stored_heads(kv, lc[name], split))
        h = yield from _dec_tail(lp, cfg, h, mk, mv)
    h = rms_norm(params["final_norm"], (yield from last_row(h)), cfg.norm_eps)
    return (yield from head_logits(params, cfg, h))[:, 0].float(), cache


def prefill(params, cfg: ModelConfig, cache: dict, frames: torch.Tensor,
            tokens: torch.Tensor):
    """Encode + teacher-force tokens, filling the self- and cross-attention
    caches in place; returns (last-position logits (B,V) float32, cache)."""
    return C.run_local(prefill_body(params, cfg, cache, frames, tokens))


def decode_body(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos):
    """Rank body of :func:`decode_step`."""
    h = yield from embed_lookup(params["embed"], cfg, tokens[:, None])
    pos = torch.as_tensor(pos, dtype=torch.int32, device=h.device).expand(
        tokens.shape[0]).contiguous()
    for i in range(cfg.n_layers):
        lp, lc = layer_slice(params["dec_layers"], i), layer_slice(cache, i)
        hh = rms_norm(lp["ln1"], h, cfg.norm_eps)
        y, lc = yield from L.attn_decode_body(lp["attn"], cfg, hh, lc, pos, 0)
        h = yield from _dec_tail(lp, cfg, h + y, lc["mem_k"], lc["mem_v"])
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return (yield from head_logits(params, cfg, h))[:, 0].float(), cache


def decode_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos):
    """One decoder token; the cross-attention reads the cached mem_k /
    mem_v. Returns (logits (B,V) float32, cache)."""
    return C.run_local(decode_body(params, cfg, cache, tokens, pos))
