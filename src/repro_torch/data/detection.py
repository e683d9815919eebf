"""Synthetic rectangle-detection data and AP evaluation (port of
repro/data/detection.py).

Images hold 1..max_boxes axis-aligned coloured rectangles; the class is
the colour index. The random draws come from a ``torch.Generator`` (JAX's
PRNG bits cannot be reproduced); the rasterised images and the dense
per-query targets over the flattened multi-scale pyramid are
deterministic functions of the drawn boxes, equal to the reference's for
the same boxes. :func:`eval_detection_ap` is the reference's greedy AP,
computed with numpy on the host from tensors or arrays."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import resolve_device

_COLORS = ((0.9, 0.1, 0.1), (0.1, 0.9, 0.1), (0.1, 0.1, 0.9), (0.9, 0.9, 0.1))


def _extent(c: torch.Tensor, wh: torch.Tensor):
    return (c[..., 0] - wh[..., 0] / 2, c[..., 0] + wh[..., 0] / 2,
            c[..., 1] - wh[..., 1] / 2, c[..., 1] + wh[..., 1] / 2)


def render_images(c, wh, cls, active, img_size: int) -> torch.Tensor:
    """(B, 3, S, S) images in [0, 1] holding the active boxes' colours."""
    s = img_size
    lin = torch.linspace(0, 1, s, device=c.device)
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    x0, x1, y0, y1 = (e[..., None, None] for e in _extent(c, wh))
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    inside = inside & active[..., None, None]                       # (B,M,S,S)
    colors = torch.tensor(_COLORS, device=c.device)[cls]            # (B,M,3)
    img = torch.einsum("bmhw,bmc->bchw", inside.to(torch.float32), colors)
    return torch.clamp(img, 0.0, 1.0)


def dense_targets(c, wh, cls, active, level_shapes: Sequence[Tuple[int, int]],
                  n_classes: int = 4):
    """Dense targets per pyramid query, the smallest containing box wins:
    tgt_cls (B, N_in) int64 (``n_classes`` = background) and tgt_box
    (B, N_in, 4) cxcywh (zeros for background)."""
    x0, x1, y0, y1 = (e[..., None] for e in _extent(c, wh))
    area = wh[..., 0] * wh[..., 1] + (~active).to(torch.float32) * 1e9
    boxes = torch.cat([c, wh], dim=-1)                              # (B,M,4)
    tgt_cls, tgt_box = [], []
    for h, w in level_shapes:
        qy, qx = torch.meshgrid(
            (torch.arange(h, device=c.device) + 0.5) / h,
            (torch.arange(w, device=c.device) + 0.5) / w, indexing="ij")
        qx = qx.reshape(1, 1, -1)
        qy = qy.reshape(1, 1, -1)
        inb = (qx >= x0) & (qx <= x1) & (qy >= y0) & (qy <= y1) \
            & active[..., None]                                     # (B,M,HW)
        score = torch.where(inb, area[..., None], 1e9)
        owner = torch.argmin(score, dim=1)                          # (B,HW)
        has = torch.any(inb, dim=1)
        tgt_cls.append(torch.where(has, torch.gather(cls, 1, owner), n_classes))
        ob = torch.gather(boxes, 1, owner[..., None].expand(-1, -1, 4))
        tgt_box.append(torch.where(has[..., None], ob, 0.0))
    return torch.cat(tgt_cls, dim=1), torch.cat(tgt_box, dim=1)


def synth_detection_batch(gen: torch.Generator, batch: int, img_size: int,
                          level_shapes: Sequence[Tuple[int, int]],
                          n_classes: int = 4, max_boxes: int = 3,
                          device="cuda"):
    """Returns images (B, 3, S, S), tgt_cls (B, N_in), tgt_box
    (B, N_in, 4) and the gt dict {"cls", "box" (cxcywh), "active"}, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    # drawn on the CPU from gen: centres in [0.2, 0.8), sizes in
    # [0.15, 0.45), at least one active box per image
    c = torch.rand((batch, max_boxes, 2), generator=gen) * 0.6 + 0.2
    wh = torch.rand((batch, max_boxes, 2), generator=gen) * 0.3 + 0.15
    cls = torch.randint(0, n_classes, (batch, max_boxes), generator=gen)
    n_act = torch.randint(1, max_boxes + 1, (batch,), generator=gen)
    active = torch.arange(max_boxes)[None] < n_act[:, None]
    noise = torch.randn((batch, 3, img_size, img_size), generator=gen)
    c, wh, cls, active, noise = (t.to(dev) for t in (c, wh, cls, active, noise))
    img = render_images(c, wh, cls, active, img_size) + 0.05 * noise
    tgt_cls, tgt_box = dense_targets(c, wh, cls, active, level_shapes, n_classes)
    gt = {"cls": cls, "box": torch.cat([c, wh], dim=-1), "active": active}
    return img, tgt_cls, tgt_box, gt


def _iou_cxcywh(a: np.ndarray, b: np.ndarray) -> float:
    ax0, ax1 = a[0] - a[2] / 2, a[0] + a[2] / 2
    ay0, ay1 = a[1] - a[3] / 2, a[1] + a[3] / 2
    bx0, bx1 = b[0] - b[2] / 2, b[0] + b[2] / 2
    by0, by1 = b[1] - b[3] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    ua = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / max(ua, 1e-9)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def eval_detection_ap(cls_logits, boxes, gt, n_classes: int = 4,
                      iou_thresh: float = 0.5, top_n: int = 50) -> float:
    """Greedy AP@IoU proxy (single operating curve, 11-pt interpolation):
    per image the ``top_n`` highest foreground scores of at least 0.05,
    each matched greedily to an unused active gt box of its class at IoU
    >= ``iou_thresh``. Inputs are tensors (any device) or arrays; the
    softmax is float32."""
    logits = torch.as_tensor(_host(cls_logits)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1).numpy()
    boxes = _host(boxes)
    records = []          # (score, is_tp)
    total_gt = 0
    for b in range(probs.shape[0]):
        fg = probs[b, :, :n_classes]
        flat = fg.reshape(-1)
        order = np.argsort(-flat)[: top_n * 4]
        gt_active = _host(gt["active"][b])
        gt_box = _host(gt["box"][b])
        gt_cls = _host(gt["cls"][b])
        total_gt += int(gt_active.sum())
        used = np.zeros(gt_box.shape[0], bool)
        picked = 0
        for oi in order:
            if picked >= top_n:
                break
            q, c = oi // n_classes, oi % n_classes
            score = flat[oi]
            if score < 0.05:
                break
            picked += 1
            tp = False
            for m in range(gt_box.shape[0]):
                if used[m] or not gt_active[m] or gt_cls[m] != c:
                    continue
                if _iou_cxcywh(boxes[b, q], gt_box[m]) >= iou_thresh:
                    used[m] = True
                    tp = True
                    break
            records.append((score, tp))
    if not records or total_gt == 0:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records])
    fps = np.cumsum([not r[1] for r in records])
    recall = tps / total_gt
    precision = tps / np.maximum(tps + fps, 1)
    ap = 0.0
    for r in np.linspace(0, 1, 11):
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
    return float(ap)
