"""Deformable-DETR-style decoder over ONE shared MSDAValueCache (port of
repro/msda/decoder.py).

The cache is built once from the encoder memory (inheriting the encoder
chain's final FWP compaction) and every layer samples it:

    layer l:  self-attention over the N_q queries
              deformable cross-attention against the SHARED cache
              FFN
              reference-point refinement  ref <- sigmoid(logit(ref) + Δ(h))

With ``cuda_decode`` the table is also staged once per memory
(``cache.staged``) and every layer's kernel launch samples the staged
table. A streaming consumer passes its persistent, incrementally updated
cache in (``cache=``) instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.bridge import resolve_device
from repro_torch.core import nn
from repro_torch.msda.attention import msda_attention_cached
from repro_torch.msda.cache import build_value_cache
from repro_torch.msda.pipeline import MSDAPipelineState
from repro_torch.msda.plan import MSDAPlan


@dataclasses.dataclass(frozen=True)
class MSDADecoderConfig:
    """Static decoder shape; the attention geometry comes from the plan."""
    n_layers: int = 6
    n_queries: int = 300
    d_ffn: int = 1024
    dtype: torch.dtype = torch.float32


def init_decoder(cfg: MSDADecoderConfig, attn_cfg, gen: torch.Generator,
                 device="cuda") -> dict:
    """Same shapes and init rules as the reference's ``init_decoder``, on
    ``device``: the card unless the caller passes ``device="cpu"``."""
    from repro_torch.core.msdeform_attn import init_msdeform_attn
    device = resolve_device(device)
    d = attn_cfg.d_model
    t = dict(dtype=cfg.dtype, device=device)
    scale = 1.0 / math.sqrt(float(d))
    shared = init_msdeform_attn(attn_cfg, gen, device)
    params = {
        "query_pos": (torch.randn((cfg.n_queries, d), generator=gen)
                      * scale).to(**t),
        "tgt_embed": (torch.randn((cfg.n_queries, d), generator=gen)
                      * scale).to(**t),
        "ref_head": nn.linear_init(gen, d, 2, **t),
        # one value projection for all layers: the build-once seam
        "value": {k: shared[k] for k in ("value_w", "value_b")},
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        cross = init_msdeform_attn(attn_cfg, gen, device)
        params["layers"].append({
            "self_q": nn.linear_init(gen, d, d, **t),
            "self_k": nn.linear_init(gen, d, d, **t),
            "self_v": nn.linear_init(gen, d, d, **t),
            "self_o": nn.linear_init(gen, d, d, **t),
            "ln_sa": nn.layer_norm_init(d, **t),
            "cross": {k: v for k, v in cross.items()
                      if k not in ("value_w", "value_b")},
            "ln1": nn.layer_norm_init(d, **t),
            "ffn1": nn.linear_init(gen, d, cfg.d_ffn, **t),
            "ffn2": nn.linear_init(gen, cfg.d_ffn, d, **t),
            "ln2": nn.layer_norm_init(d, **t),
            "ref_delta": {"w": torch.zeros((d, 2), **t),
                          "b": torch.zeros((2,), **t)},
        })
    return params


def decoder_logical_axes(cfg: MSDADecoderConfig) -> dict:
    """Logical sharding axes per parameter (see distributed/sharding.py)."""
    lin = {"w": ("embed", None), "b": (None,)}
    ln = {"scale": (None,), "bias": (None,)}
    layer = {
        "self_q": lin, "self_k": lin, "self_v": lin, "self_o": lin,
        "ln_sa": ln,
        "cross": {"attn_w": ("embed", "heads", None), "attn_b": ("heads", None),
                  "offs_w": ("embed", "heads", None), "offs_b": ("heads", None),
                  "out_w": ("heads", None, "embed"), "out_b": (None,)},
        "ln1": ln, "ffn1": {"w": ("embed", "mlp"), "b": ("mlp",)},
        "ffn2": {"w": ("mlp", "embed"), "b": (None,)}, "ln2": ln,
        "ref_delta": lin,
    }
    return {
        "query_pos": (None, "embed"), "tgt_embed": (None, "embed"),
        "ref_head": lin,
        "value": {"value_w": ("embed", "heads", None), "value_b": ("heads", None)},
        "layers": [layer for _ in range(cfg.n_layers)],
    }


def _self_attention(layer: dict, h: torch.Tensor, pos: torch.Tensor,
                    n_heads: int) -> torch.Tensor:
    """Standard MHA over the N_q queries (pos added to q/k, not v); plain
    matmul + softmax, as the reference computes it outside any kernel."""
    b, n, d = h.shape
    dh = d // n_heads
    q = nn.linear(layer["self_q"], h + pos).reshape(b, n, n_heads, dh)
    k = nn.linear(layer["self_k"], h + pos).reshape(b, n, n_heads, dh)
    v = nn.linear(layer["self_v"], h).reshape(b, n, n_heads, dh)
    att = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) \
        / math.sqrt(float(dh))
    att = torch.softmax(att, dim=-1)
    out = torch.matmul(att, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    return nn.linear(layer["self_o"], out.reshape(b, n, d))


def decoder_apply(params: dict, cfg: MSDADecoderConfig, plan: MSDAPlan,
                  memory: torch.Tensor,
                  state: Optional[MSDAPipelineState] = None, *,
                  collect_stats: bool = False, cache=None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, MSDAPipelineState]:
    """Run the decoder stack against ONE shared value cache.

    ``state`` carries the encoder chain's final FWP link; ``cache`` is a
    prebuilt :class:`~repro_torch.msda.cache.MSDAValueCache` (the
    streaming engine's persistent one), else one is built here from
    ``memory``. Returns (h (B, N_q, D), refs (B, N_q, 2), decoder state
    with one stats entry per layer, the shared cache and the caller's
    ``state.stream`` accounting)."""
    b = memory.shape[0]
    attn_cfg = plan.cfg
    if cache is None:
        cache = build_value_cache(params["value"], plan, memory, state)
    if plan.backend == "cuda_decode" and cache.staged is None:
        raise RuntimeError("cuda_decode plan produced an unstaged cache")
    dstate = MSDAPipelineState(
        fwp=getattr(state, "fwp", None),
        stream=getattr(state, "stream", None)).with_cache(cache)

    pos = params["query_pos"][None]                         # (1, Nq, D)
    h = params["tgt_embed"][None].expand((b,) + params["tgt_embed"].shape)
    refs = torch.sigmoid(nn.linear(params["ref_head"], params["query_pos"]))
    refs = refs[None].expand((b,) + refs.shape)             # (B, Nq, 2)

    for layer in params["layers"]:
        h = nn.layer_norm(layer["ln_sa"],
                          h + _self_attention(layer, h, pos, attn_cfg.n_heads))
        attn_out, dstate = msda_attention_cached(
            layer["cross"], plan, h + pos, refs, dstate.cache,
            state=dstate, collect_stats=collect_stats, update_fwp=False)
        h = nn.layer_norm(layer["ln1"], h + attn_out)
        ff = nn.linear(layer["ffn2"], torch.relu(nn.linear(layer["ffn1"], h)))
        h = nn.layer_norm(layer["ln2"], h + ff)
        # incoming refs detached (truncated chain), the delta stays live
        delta = h @ layer["ref_delta"]["w"] + layer["ref_delta"]["b"]
        refs = torch.sigmoid(nn.inverse_sigmoid(refs.detach()) + delta)
    return h, refs, dstate
