"""Deformable-DETR-style encoder: MSDeformAttn blocks with the DEFA
block-to-block FWP mask chain (port of repro/core/encoder.py).

Block k counts sampled-pixel frequency during its MSGS and hands the
resulting fmap mask to block k+1, which prunes its value projection with
it (the first block runs unpruned). One plan serves every block.

:func:`encoder_body` is the same encoder as a rank body
(``distributed.collectives``): under the tensor-parallel context, on
the rank's columns of each block's ``ffn1`` and rows of its ``ffn2``
(the reference's rule table splits the FFN over the model axis and
keeps the 8 attention heads whole, ``launch.detr_cells``), the FFN's
input enters through ``act_sharding.model_copy`` and its output leaves
through ``act_sharding.model_sum``, as ``models.layers.mlp_body``
does. Under ``act_sharding.batch_split`` (a rank holding its images of
a batch split over the data axes) each block's INT12 scales are the
whole batch's (``msda.attention.msda_attention_body``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.bridge import resolve_device
from repro_torch.core import nn
from repro_torch.core.msdeform_attn import (MSDeformAttnConfig,
                                            init_msdeform_attn, logical_axes)
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.msda.attention import msda_attention_body
from repro_torch.msda.pipeline import MSDAPipelineState
from repro_torch.msda.plan import make_plan


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    attn: MSDeformAttnConfig = dataclasses.field(default_factory=MSDeformAttnConfig)
    n_blocks: int = 6
    d_ffn: int = 1024
    dtype: torch.dtype = torch.float32

    @property
    def d_model(self) -> int:
        return self.attn.d_model


def init_encoder(cfg: EncoderConfig, gen: torch.Generator,
                 device="cuda") -> dict:
    """Random blocks drawn from ``gen`` on ``device``, the card unless the
    caller passes ``device="cpu"``."""
    device = resolve_device(device)
    t = dict(dtype=cfg.dtype, device=device)
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "attn": init_msdeform_attn(cfg.attn, gen, device),
            "ln1": nn.layer_norm_init(cfg.d_model, **t),
            "ln2": nn.layer_norm_init(cfg.d_model, **t),
            "ffn1": nn.linear_init(gen, cfg.d_model, cfg.d_ffn, **t),
            "ffn2": nn.linear_init(gen, cfg.d_ffn, cfg.d_model, **t),
        })
    return {"blocks": blocks}


def encoder_logical_axes(cfg: EncoderConfig) -> dict:
    blk = {
        "attn": logical_axes(cfg.attn),
        "ln1": {"scale": (None,), "bias": (None,)},
        "ln2": {"scale": (None,), "bias": (None,)},
        "ffn1": {"w": ("embed", "mlp"), "b": ("mlp",)},
        "ffn2": {"w": ("mlp", "embed"), "b": (None,)},
    }
    return {"blocks": [blk for _ in range(cfg.n_blocks)]}


def ffn_body(blk: dict, cfg: EncoderConfig, h: torch.Tensor):
    """Rank body step: a block's FFN, ``ffn2(relu(ffn1(h)))``. On the
    rank's slice of the FFN dim (``ffn2``'s rows fewer than
    ``cfg.d_ffn``) its partial product, the model axis's sum (float32,
    rank order, rounded once), then ``ffn2``'s bias once; whole leaves
    compute as :func:`encoder_apply` does."""
    if blk["ffn2"]["w"].shape[0] == cfg.d_ffn:
        return nn.linear(blk["ffn2"], torch.relu(nn.linear(blk["ffn1"], h)))
    h = yield from acts.model_copy(h)
    hid, w2 = nn.promoted(torch.relu(nn.linear(blk["ffn1"], h)),
                          blk["ffn2"]["w"])
    y = yield from acts.model_sum(hid @ w2)
    y, b2 = nn.promoted(y, blk["ffn2"]["b"])
    return y + b2


def encoder_body(params: dict, cfg: EncoderConfig,
                 x_flat: torch.Tensor,            # (B, N_in, D)
                 pos_embed: torch.Tensor,         # (N_in, D)
                 ref_points: torch.Tensor,        # (N_in, 2) or (B, N_in, 2)
                 level_shapes: Sequence[Tuple[int, int]], *,
                 collect_stats: bool = False,
                 backend: Optional[str] = None,
                 return_state: bool = False):
    """Rank body of :func:`encoder_apply`: the attention of every block
    whole (its heads replicated), the FFN on the rank's shard
    (:func:`ffn_body`). Returns what :func:`encoder_apply` returns."""
    b = x_flat.shape[0]
    if ref_points.dim() == 2:
        ref_points = ref_points[None].expand((b,) + ref_points.shape)
    plan = make_plan(cfg.attn, tuple((int(lh), int(lw))
                                     for lh, lw in level_shapes),
                     backend=backend, device=x_flat.device)
    h = x_flat
    state = MSDAPipelineState.initial()
    for blk in params["blocks"]:
        q = h + pos_embed[None]
        attn_out, state = yield from msda_attention_body(
            blk["attn"], plan, q, ref_points, h, state=state,
            collect_stats=collect_stats)
        h = nn.layer_norm(blk["ln1"], h + attn_out)
        ff = yield from ffn_body(blk, cfg, h)
        h = nn.layer_norm(blk["ln2"], h + ff)
    aux = {"blocks": list(state.block_stats)}
    if return_state:
        return h, aux, state
    return h, aux


def encoder_apply(params: dict, cfg: EncoderConfig,
                  x_flat: torch.Tensor,            # (B, N_in, D)
                  pos_embed: torch.Tensor,         # (N_in, D)
                  ref_points: torch.Tensor,        # (N_in, 2) or (B, N_in, 2)
                  level_shapes: Sequence[Tuple[int, int]], *,
                  collect_stats: bool = False,
                  backend: Optional[str] = None,
                  return_state: bool = False):
    """Returns (features (B, N_in, D), aux with per-block DEFA stats) and,
    with ``return_state``, the final :class:`MSDAPipelineState` whose FWP
    link the decoder's shared cache inherits. Off any mesh:
    :func:`encoder_body` on whole leaves, run locally."""
    return C.run_local(encoder_body(
        params, cfg, x_flat, pos_embed, ref_points, level_shapes,
        collect_stats=collect_stats, backend=backend,
        return_state=return_state))
