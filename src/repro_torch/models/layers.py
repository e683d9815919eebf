"""GQA attention (full / blockwise / sliding-window / decode) and the MLP
(port of the attention and MLP parts of ``repro/models/layers.py``).

Per-layer params are plain dicts, stacked by the decoder on a leading
layer axis. The reference's sharding hints (``_constrain_attn`` and the
``acts.constrain_*`` calls) pin activation shardings on a device mesh and
are no-ops on one device; they are dropped here.

One deviation from the reference: :func:`attn_decode` computes its
attention through ``kernels.ops.flash_decode`` (kernel K5 on the card,
its plain version on the CPU), where the reference computes it in plain
jnp. K5 masks with -1e30 instead of ``BIG_NEG`` (no effect while the
token's own slot is valid), keeps the probabilities in float32 where the
reference rounds them to the model dtype, and sums P.V in float32.

MoE and the Mamba2 SSD mixer are not ported yet (ROADMAP.md)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, gelu, init_dense, rope

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


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, hkv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, hkv, n_rep, dh).reshape(
        b, s, hkv * n_rep, dh)


def _kv_for_q(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """Map kv heads to PHYSICAL q heads: the usual GQA repeat without
    padding; with padded q heads, real heads keep their q->kv grouping and
    padded heads clamp to the last kv head (their output is masked)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if cfg.h_phys == cfg.n_heads:
        return _repeat_kv(k, n_rep)
    hmap = np.minimum(np.arange(cfg.h_phys) // n_rep, cfg.n_kv_heads - 1)
    return k[:, :, torch.from_numpy(hmap).to(k.device)]


def _head_mask(cfg: ModelConfig, dtype, device=None):
    if cfg.h_phys == cfg.n_heads:
        return None
    m = torch.zeros((cfg.h_phys,), dtype=dtype, device=device)
    m[:cfg.n_heads] = 1.0
    return m


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


def _attn_blockwise(q, k, v, window, chunk: int):
    """Flash-style online-softmax attention, O(chunk²) memory per step.

    q,k,v: (B,S,Hq,Dh) (kv already repeated). Every q chunk scans every
    kv chunk, masked by causality and the window, as the reference's
    ``lax.scan`` does."""
    b, s, h, dh = q.shape
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    scale = 1.0 / math.sqrt(dh)
    ar = torch.arange(chunk, dtype=torch.int32, device=q.device)
    outs = []
    for qi in range(nc):
        q_i = q[:, qi * chunk:(qi + 1) * chunk]
        m = torch.full((b, h, chunk), BIG_NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, chunk, dh), dtype=torch.float32,
                          device=q.device)
        for kj in range(nc):
            k_j = k[:, kj * chunk:(kj + 1) * chunk]
            v_j = v[:, kj * chunk:(kj + 1) * chunk]
            s_ij = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j).float() * scale
            mask = _causal_window_mask(qi * chunk + ar, kj * chunk + ar, window)
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


def _attend(cfg, q, k, v, positions, window):
    """The full-sequence attention of forward and prefill: blockwise when
    the sequence is long and divides into ``attn_chunk``, else dense;
    padded heads masked."""
    s = q.shape[1]
    if cfg.attn_impl != "dense" and s > 2 * cfg.attn_chunk \
            and s % cfg.attn_chunk == 0:
        out = _attn_blockwise(q, _kv_for_q(cfg, k), _kv_for_q(cfg, v),
                              window, cfg.attn_chunk)
    else:
        out = _attn_dense(q, _kv_for_q(cfg, k), _kv_for_q(cfg, v),
                          positions, positions, window)
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    return out


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, window) -> torch.Tensor:
    """Full-sequence causal attention. x (B,S,D); positions (S,) int32."""
    q, k, v = _project_qkv(p, cfg, x, positions[None])
    out = _attend(cfg, q, k, v, positions, window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


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
    and returns (y, cache)."""
    w = cache["k"].shape[1]
    q, k, v = _project_qkv(p, cfg, x, positions[None])
    out = _attend(cfg, q, k, v, positions, window)
    slots = (positions % w).long()
    cache["k"][:, slots] = k
    cache["v"][:, slots] = v
    cache["kpos"][:, slots] = positions[None].to(torch.int32)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def check_decode_heads(cfg: ModelConfig) -> None:
    """K5 gives query head h the KV head ``h // ceil(Hq / Hkv)``; the
    model's mapping (``_kv_for_q``) is the same only without padded
    heads and when Hkv divides Hq."""
    if cfg.h_phys != cfg.n_heads or cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(
            f"attn_decode: {cfg.name} has {cfg.h_phys} physical query heads "
            f"({cfg.n_heads} real) over {cfg.n_kv_heads} KV heads; the "
            "flash-decode kernel maps query head h to KV head "
            "h // ceil(Hq / Hkv), which is the model's mapping only when "
            "there are no padded heads and Hkv divides Hq")


def attn_decode(p, cfg, x1, cache, pos, window):
    """One-token decode. x1 (B,1,D); pos (B,) int32 per-request positions
    (continuous batching); ring-buffer cache, written in place. The
    attention runs through ``ops.flash_decode`` (K5)."""
    check_decode_heads(cfg)
    b = x1.shape[0]
    w = cache["k"].shape[1]
    q, k, v = _project_qkv(p, cfg, x1, pos[:, None])
    slot = (pos % w).long()                                       # (B,)
    bidx = torch.arange(b, device=x1.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["kpos"][bidx, slot] = pos
    kpos = cache["kpos"]
    valid = (kpos <= pos[:, None]) & (kpos > pos[:, None] - _window(window))
    out = ops.flash_decode(q[:, 0].contiguous(), cache["k"], cache["v"], valid)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]
    return y, cache


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


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]
