"""Synthetic rectangle-detection data (port of the data half of
repro/data/detection.py; the AP evaluation is not ported yet).

Images hold 1..max_boxes axis-aligned coloured rectangles; the class is
the colour index. The random draws come from a ``torch.Generator`` (JAX's
PRNG bits cannot be reproduced); the rasterised images and the dense
per-query targets over the flattened multi-scale pyramid are
deterministic functions of the drawn boxes, equal to the reference's for
the same boxes."""
from __future__ import annotations

from typing import Sequence, Tuple

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
