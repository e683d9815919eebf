"""End-to-end detector around the deformable encoder, with its training
losses (port of repro/core/detector.py).

A conv backbone builds a 4-level pyramid (strides 4/8/16/32), the DEFA
encoder refines it, and a head predicts class + box: the dense per-pixel
head (``decoder=None``) or the deformable-DETR decoder head, whose N_q
learned queries cross-attend the encoder memory through ONE shared value
cache. :func:`detection_loss` trains the dense head, and
:func:`decoder_detection_loss` the decoder head through the set
matching of :func:`match_queries` (scipy on the host)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.core import nn
from repro_torch.core.encoder import EncoderConfig, encoder_apply, init_encoder
from repro_torch.msda.decoder import (MSDADecoderConfig, decoder_apply,
                                      init_decoder)

try:                                       # optional dependency
    from scipy.optimize import linear_sum_assignment as _linear_sum_assignment
except ImportError:                        # pragma: no cover - env-dependent
    _linear_sum_assignment = None


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


def decoder_plan(cfg: DetectorConfig, backend: Optional[str] = None, *,
                 device=None):
    """The decode-shaped MSDAPlan of the decoder head, for ``device``
    (see :func:`repro_torch.msda.plan.plan_for`). A raster-only backend
    request degrades to ``auto`` for the decoder."""
    from repro_torch.msda.backends import backend_info
    from repro_torch.msda.plan import plan_for
    if cfg.decoder is None:
        raise ValueError("decoder_plan needs a detector with a decoder head")
    dec_backend = backend or getattr(cfg.encoder.attn, "backend", None)
    if dec_backend is not None and dec_backend != "auto" \
            and backend_info(dec_backend).raster_only:
        dec_backend = "auto"
    return plan_for(cfg.encoder.attn, cfg.level_shapes, dec_backend,
                    cfg.decoder.n_queries, cfg.decoder.n_layers,
                    device=device)


def encoder_backend(backend: Optional[str],
                    own: Optional[str] = None) -> Optional[str]:
    """Decode-only backends (``cuda_decode``) have no raster launch: for
    the encoder such a request degrades to ``own``, the config's own
    backend (``cfg.encoder.attn.backend``), when that names a raster
    backend, and to ``auto`` otherwise, as in the reference. A trainer
    sets ``own="torch_gather"``: ``auto``'s raster pick K1 is
    forward-only and refuses autograd."""
    from repro_torch.msda.backends import backend_info
    if backend is not None and backend != "auto" \
            and backend_info(backend).decode_only:
        if own is not None and own != "auto" \
                and not backend_info(own).decode_only:
            return own
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
        collect_stats=collect_stats,
        backend=encoder_backend(backend, getattr(cfg.encoder.attn, "backend",
                                                 None)),
        return_state=True)

    if cfg.decoder is None:
        cls_logits = nn.linear(params["cls_head"], enc)
        boxes = torch.sigmoid(nn.linear(params["box_head"], enc))
        return cls_logits, boxes, aux

    plan = decoder_plan(cfg, backend, device=dev)
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


def _class_loss(cls_logits: torch.Tensor, tgt_cls: torch.Tensor,
                n_classes: int) -> torch.Tensor:
    """Class-balanced cross entropy: positives weigh 5, background 1."""
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, -1, tgt_cls.long()[..., None])[..., 0]
    pos = (tgt_cls < n_classes).to(torch.float32)
    w = torch.where(pos > 0, 5.0, 1.0)
    return torch.sum(ce * w) / torch.sum(w)


def detection_loss(params: dict, cfg: DetectorConfig, images: torch.Tensor,
                   tgt_cls: torch.Tensor, tgt_box: torch.Tensor, *,
                   backend: Optional[str] = None):
    """Dense per-query assignment loss (per-pixel head).

    tgt_cls: (B, N_in) int — class index, n_classes == background.
    tgt_box: (B, N_in, 4) — cxcywh of the owning box (zeros for
    background). Returns (loss, {"cls_loss", "box_loss"})."""
    cls_logits, boxes, _ = detector_apply(params, cfg, images, backend=backend)
    cls_loss = _class_loss(cls_logits, tgt_cls, cfg.n_classes)
    pos = (tgt_cls < cfg.n_classes).to(torch.float32)
    l1 = torch.sum(torch.abs(boxes - tgt_box), dim=-1)
    box_loss = torch.sum(l1 * pos) / torch.clamp(torch.sum(pos), min=1.0)
    return cls_loss + box_loss, {"cls_loss": cls_loss, "box_loss": box_loss}


_INACTIVE_COST = 1e6


def _hungarian_owners_host(cost: np.ndarray) -> np.ndarray:
    """Host-side optimal assignment per batch element: owner[b, m] is the
    query column assigned to gt row m (rows than columns or fewer)."""
    owner = np.zeros(cost.shape[:2], np.int32)
    for b in range(cost.shape[0]):
        row, col = _linear_sum_assignment(cost[b])
        owner[b, row] = col.astype(np.int32)
    return owner


def match_queries(cost: torch.Tensor, gt_active: torch.Tensor,
                  matcher: Optional[str] = None) -> torch.Tensor:
    """gt -> query assignment (B, M) int32 for the set-prediction loss.

    ``cost`` (B, M, Nq) is consumed detached: the assignment is a discrete
    decision, gradients flow through the matched boxes. ``"hungarian"``
    copies the cost to the host and runs scipy's
    ``linear_sum_assignment`` (every active gt gets a distinct query;
    inactive rows take a constant cost, non-finite entries become large
    finite ones); ``"greedy"`` is the per-gt argmin, collisions allowed,
    and the fallback without scipy or with more gts than queries.
    ``matcher=None`` picks hungarian when scipy is installed."""
    if matcher is None:
        matcher = "hungarian" if _linear_sum_assignment is not None \
            else "greedy"
    if matcher not in ("hungarian", "greedy"):
        raise ValueError(f"unknown matcher {matcher!r}")
    cost = cost.detach()
    _, m, nq = cost.shape
    if matcher == "greedy" or _linear_sum_assignment is None or m > nq:
        return torch.argmin(cost, dim=-1).to(torch.int32)
    cost = torch.where(gt_active[:, :, None], cost, _INACTIVE_COST)
    cost = torch.nan_to_num(cost, nan=_INACTIVE_COST, posinf=_INACTIVE_COST,
                            neginf=-_INACTIVE_COST)
    owner = _hungarian_owners_host(cost.cpu().numpy())
    return torch.from_numpy(owner).to(cost.device)


def decoder_detection_loss(params: dict, cfg: DetectorConfig,
                           images: torch.Tensor, gt_cls: torch.Tensor,
                           gt_box: torch.Tensor, gt_active: torch.Tensor,
                           matcher: Optional[str] = None, *,
                           backend: Optional[str] = None):
    """Set-prediction loss for the decoder head.

    Each ACTIVE gt box is assigned the query whose predicted box is
    closest in L1 (:func:`match_queries`); matched queries learn class and
    box, the rest learn background. Class targets are derived query-side:
    an inactive gt never claims a query, and under the greedy matcher a
    collision goes to the lowest gt index.

    gt_cls (B, M) int, gt_box (B, M, 4) cxcywh, gt_active (B, M) bool.
    ``backend=None`` is the reference's behaviour; see
    :func:`encoder_backend` for a decode-only request."""
    if cfg.decoder is None:
        raise ValueError("decoder_detection_loss needs a decoder head")
    cls_logits, boxes, _ = detector_apply(params, cfg, images, backend=backend)
    _, nq, _ = cls_logits.shape

    cost = torch.sum(torch.abs(boxes[:, None] - gt_box[:, :, None]), -1)
    owner = match_queries(cost, gt_active, matcher)                 # (B, M)

    queries = torch.arange(nq, device=owner.device)
    claimed = (owner[:, :, None] == queries[None, None]) \
        & gt_active[:, :, None]                                     # (B, M, Nq)
    matched = torch.any(claimed, dim=1)                             # (B, Nq)
    first_m = torch.argmax(claimed.to(torch.int32), dim=1)          # (B, Nq)
    cls_of = torch.gather(gt_cls.long(), 1, first_m)
    tgt_cls = torch.where(matched, cls_of, cfg.n_classes)
    cls_loss = _class_loss(cls_logits, tgt_cls, cfg.n_classes)

    matched_box = torch.gather(boxes, 1, owner.long()[..., None].expand(-1, -1, 4))
    l1 = torch.sum(torch.abs(matched_box - gt_box), dim=-1)
    act = gt_active.to(torch.float32)
    box_loss = torch.sum(l1 * act) / torch.clamp(torch.sum(act), min=1.0)
    return cls_loss + box_loss, {"cls_loss": cls_loss, "box_loss": box_loss}
