"""Deformable-DETR-style encoder: MSDeformAttn blocks with the DEFA
block-to-block FWP mask chain (port of repro/core/encoder.py).

Block k counts sampled-pixel frequency during its MSGS and hands the
resulting fmap mask to block k+1, which prunes its value projection with
it (the first block runs unpruned). One plan serves every block."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import nn
from repro_torch.core.msdeform_attn import MSDeformAttnConfig, init_msdeform_attn
from repro_torch.msda.attention import msda_attention
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


def init_encoder(cfg: EncoderConfig, gen: torch.Generator, device="cpu") -> dict:
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
    link the decoder's shared cache inherits."""
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
        attn_out, state = msda_attention(blk["attn"], plan, q, ref_points, h,
                                         state=state,
                                         collect_stats=collect_stats)
        h = nn.layer_norm(blk["ln1"], h + attn_out)
        ff = nn.linear(blk["ffn2"], torch.relu(nn.linear(blk["ffn1"], h)))
        h = nn.layer_norm(blk["ln2"], h + ff)
    aux = {"blocks": list(state.block_stats)}
    if return_state:
        return h, aux, state
    return h, aux
