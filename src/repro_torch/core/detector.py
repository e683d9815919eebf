"""End-to-end detector around the deformable encoder (port of the forward
half of repro/core/detector.py; the losses and ``match_queries`` wait for
the training slice).

A conv backbone builds a 4-level pyramid (strides 4/8/16/32), the DEFA
encoder refines it, and a head predicts class + box: the dense per-pixel
head (``decoder=None``) or the deformable-DETR decoder head, whose N_q
learned queries cross-attend the encoder memory through ONE shared value
cache."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.bridge import resolve_device
from repro_torch.core import nn
from repro_torch.core.encoder import EncoderConfig, encoder_apply, init_encoder
from repro_torch.msda.decoder import (MSDADecoderConfig, decoder_apply,
                                      init_decoder)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    img_size: int = 64
    n_classes: int = 4                     # + background
    backbone_width: int = 32
    dtype: torch.dtype = torch.float32
    decoder: Optional[MSDADecoderConfig] = None

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        s = self.img_size
        return tuple((s // k, s // k) for k in (4, 8, 16, 32))

    @property
    def d_model(self) -> int:
        return self.encoder.d_model


def init_detector(cfg: DetectorConfig, gen: Optional[torch.Generator] = None,
                  device="cuda") -> dict:
    """Random weights with the reference's shapes and init rules, drawn
    from ``gen`` (a CPU generator; default seed 0) and placed on
    ``device`` — the card unless the caller passes ``device="cpu"``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    w, d = cfg.backbone_width, cfg.d_model
    t = dict(dtype=cfg.dtype, device=dev)
    params = {
        "stem": nn.conv_init(gen, 3, 3, w, **t),            # stride 2
        "c1": nn.conv_init(gen, 3, w, w, **t),              # -> /4
        "c2": nn.conv_init(gen, 3, w, w, **t),              # -> /8
        "c3": nn.conv_init(gen, 3, w, w, **t),              # -> /16
        "c4": nn.conv_init(gen, 3, w, w, **t),              # -> /32
        "proj": [nn.linear_init(gen, w, d, **t) for _ in range(4)],
        "encoder": init_encoder(cfg.encoder, gen, dev),
        "cls_head": nn.linear_init(gen, d, cfg.n_classes + 1, **t),
        "box_head": nn.linear_init(gen, d, 4, **t),
    }
    if cfg.decoder is not None:
        params["decoder"] = init_decoder(cfg.decoder, cfg.encoder.attn, gen, dev)
    return params


def decoder_plan(cfg: DetectorConfig, backend: Optional[str] = None):
    """The decode-shaped MSDAPlan of the decoder head. A raster-only
    backend request degrades to ``auto`` for the decoder."""
    from repro_torch.msda.backends import backend_info
    from repro_torch.msda.plan import plan_for
    if cfg.decoder is None:
        raise ValueError("decoder_plan needs a detector with a decoder head")
    dec_backend = backend or getattr(cfg.encoder.attn, "backend", None)
    if dec_backend is not None and dec_backend != "auto" \
            and backend_info(dec_backend).raster_only:
        dec_backend = "auto"
    return plan_for(cfg.encoder.attn, cfg.level_shapes, dec_backend,
                    cfg.decoder.n_queries, cfg.decoder.n_layers)


def encoder_backend(backend: Optional[str]) -> Optional[str]:
    """Decode-only backends (``cuda_decode``) have no raster launch: such a
    request degrades to ``auto`` for the encoder."""
    from repro_torch.msda.backends import backend_info
    if backend is not None and backend != "auto" \
            and backend_info(backend).decode_only:
        return "auto"
    return backend


def _pyramid(params, images: torch.Tensor):
    """images (B,3,S,S) -> list of 4 fmaps (B, w, H_l, W_l)."""
    x = torch.relu(nn.conv2d(params["stem"], images, stride=2))
    feats = []
    for name in ("c1", "c2", "c3", "c4"):
        x = torch.relu(nn.conv2d(params[name], x, stride=2))
        feats.append(x)
    return feats


def detector_apply(params: dict, cfg: DetectorConfig, images: torch.Tensor,
                   *, collect_stats: bool = False,
                   backend: Optional[str] = None):
    """Returns (cls_logits (B,Nq,C+1), boxes (B,Nq,4 cxcywh), aux); runs on
    the device of ``params`` and ``images``. Nq is N_in (per-pixel head)
    or ``cfg.decoder.n_queries`` (decoder head)."""
    dev = images.device
    feats = _pyramid(params, images)
    flat = []
    for f, proj in zip(feats, params["proj"]):
        b, c, h, w = f.shape
        flat.append(nn.linear(proj, f.permute(0, 2, 3, 1).reshape(b, h * w, c)))
    x_flat = torch.cat(flat, dim=1)                                 # (B, N_in, D)

    level_shapes = cfg.level_shapes
    pos = torch.cat([nn.sine_pos_embed_2d(h, w, cfg.d_model, device=dev)
                     for h, w in level_shapes], dim=0)
    refs = nn.reference_points_for_levels(level_shapes, device=dev)
    enc, aux, state = encoder_apply(
        params["encoder"], cfg.encoder, x_flat, pos, refs, level_shapes,
        collect_stats=collect_stats, backend=encoder_backend(backend),
        return_state=True)

    if cfg.decoder is None:
        cls_logits = nn.linear(params["cls_head"], enc)
        boxes = torch.sigmoid(nn.linear(params["box_head"], enc))
        return cls_logits, boxes, aux

    plan = decoder_plan(cfg, backend)
    hs, dec_refs, dstate = decoder_apply(params["decoder"], cfg.decoder, plan,
                                         enc, state,
                                         collect_stats=collect_stats)
    cls_logits = nn.linear(params["cls_head"], hs)
    raw = nn.linear(params["box_head"], hs)
    cxy = torch.sigmoid(raw[..., :2] + nn.inverse_sigmoid(dec_refs))
    wh = torch.sigmoid(raw[..., 2:])
    boxes = torch.cat([cxy, wh], dim=-1)
    aux = dict(aux)
    aux["decoder_blocks"] = list(dstate.block_stats)
    return cls_logits, boxes, aux
