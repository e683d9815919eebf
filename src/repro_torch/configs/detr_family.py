"""The paper's own benchmark family: Deformable-DETR / DN-DETR / DINO
encoder stacks built around MSDeformAttn + the DEFA optimization stack
(port of repro/configs/detr_family.py).

Standard encoder geometry: d_model=256, 8 heads, 4 levels x 4 points,
6 blocks, d_ffn 1024; pyramid for an 800x1333 COCO image (strides
8/16/32/64). The DEFA variants turn on PAP top-4, FWP compact at 0.6,
range narrowing (16, 12, 8, 4) and INT12 weights and activations."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.encoder import EncoderConfig
from repro_torch.core.msdeform_attn import MSDeformAttnConfig

# 800x1333 input, strides 8,16,32,64 (official deformable-DETR pyramid)
LEVEL_SHAPES = ((100, 167), (50, 84), (25, 42), (13, 21))
N_IN = sum(h * w for h, w in LEVEL_SHAPES)                 # 22223 queries


@dataclasses.dataclass(frozen=True)
class DetrArchConfig:
    name: str
    encoder: EncoderConfig
    level_shapes: tuple = LEVEL_SHAPES
    serve_batch: int = 64          # images per serving step (fleet-scale)
    train_batch: int = 256


def _enc(n_blocks: int, defa: bool, dtype=torch.bfloat16) -> EncoderConfig:
    attn = MSDeformAttnConfig(
        d_model=256, n_heads=8, n_levels=4, n_points=4,
        pap_mode="topk" if defa else "off", pap_keep=4,
        fwp_mode="compact" if defa else "off", fwp_k=1.0, fwp_capacity=0.6,
        range_narrow=(16.0, 12.0, 8.0, 4.0) if defa else None,
        act_bits=12 if defa else None, weight_bits=12 if defa else None,
        impl="jnp", dtype=dtype)
    return EncoderConfig(attn=attn, n_blocks=n_blocks, d_ffn=1024, dtype=dtype)


# baseline (paper-faithful MSDeformAttn, no pruning) and DEFA-optimized
CONFIGS = {
    "deformable-detr": DetrArchConfig("deformable-detr", _enc(6, defa=False)),
    "deformable-detr-defa": DetrArchConfig("deformable-detr-defa", _enc(6, defa=True)),
    "dn-detr": DetrArchConfig("dn-detr", _enc(6, defa=False)),
    "dino": DetrArchConfig("dino", _enc(6, defa=False)),
    "dino-defa": DetrArchConfig("dino-defa", _enc(6, defa=True)),
}


def with_dtype(enc: EncoderConfig, dtype: torch.dtype) -> EncoderConfig:
    """The encoder config with every compute dtype replaced (the serving
    slice runs the bf16 family configs in float32)."""
    return dataclasses.replace(enc, dtype=dtype,
                               attn=dataclasses.replace(enc.attn, dtype=dtype))
