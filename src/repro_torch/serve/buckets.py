"""Shape buckets + admission control for the DETR serve engine (port of
repro/serve/buckets.py).

Serving derives a small set of square resolution buckets from the
detector config — each a (resolution, level_shapes, MSDAPlan) triple —
and routes every incoming image to the smallest bucket it fits, padding
up; oversized images are rejected at admission."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: the detector's fixed pyramid strides (DetectorConfig.level_shapes)
STRIDES = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """One serving shape: a square resolution, the detector config rebound
    to it (params are resolution-independent), and its MSDAPlan."""
    resolution: int
    cfg: object                 # DetectorConfig with img_size == resolution
    plan: object                # MSDAPlan for this bucket's level shapes

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return self.cfg.level_shapes

    @property
    def n_in(self) -> int:
        return self.plan.n_in

    def fits(self, h: int, w: int) -> bool:
        return h <= self.resolution and w <= self.resolution


def derive_buckets(cfg, resolutions, *, backend: Optional[str] = None,
                   device=None) -> Tuple[ShapeBucket, ...]:
    """Derive the serving buckets from a detector config; each resolution
    must divide the pyramid strides. ``device``: the device the plans are
    for (its platform's budgets and measured entry)."""
    from repro_torch.core.detector import decoder_plan
    from repro_torch.msda.plan import level_shapes_for_resolution, plan_for

    res = sorted({int(r) for r in resolutions})
    if not res:
        raise ValueError("at least one bucket resolution is required")
    buckets = []
    for r in res:
        shapes = level_shapes_for_resolution(r, strides=STRIDES)
        bcfg = dataclasses.replace(cfg, img_size=r)
        if getattr(bcfg, "decoder", None) is not None:
            plan = decoder_plan(bcfg, backend, device=device)
        else:
            plan = plan_for(bcfg.encoder.attn, shapes, backend,
                            device=device)
        buckets.append(ShapeBucket(resolution=r, cfg=bcfg, plan=plan))
    return tuple(buckets)


class BucketRouter:
    """Route each incoming image to the smallest bucket it fits."""

    def __init__(self, buckets: Tuple[ShapeBucket, ...]):
        self.buckets = tuple(sorted(buckets, key=lambda b: b.resolution))
        if not self.buckets:
            raise ValueError("BucketRouter needs at least one bucket")

    @property
    def max_resolution(self) -> int:
        return self.buckets[-1].resolution

    def route(self, h: int, w: int) -> Optional[ShapeBucket]:
        """Smallest bucket admitting an (h, w) image; None when oversized."""
        for b in self.buckets:
            if b.fits(h, w):
                return b
        return None

    def admit(self, image) -> Tuple[Optional[ShapeBucket], Optional[str]]:
        """Admission control: (bucket, None) or (None, rejection reason)."""
        shape = tuple(getattr(image, "shape", ()))
        if len(shape) != 3 or shape[0] != 3:
            return None, f"expected a (3, H, W) image, got shape {shape}"
        _, h, w = shape
        if h < 1 or w < 1:
            return None, f"degenerate image shape {shape}"
        b = self.route(int(h), int(w))
        if b is None:
            return None, (f"image {h}x{w} exceeds the largest bucket "
                          f"({self.max_resolution}px); split or downscale "
                          "and resubmit")
        return b, None

    def table(self) -> list:
        """The bucket table (the reference's ``BucketRouter.table``)."""
        return [{"resolution": b.resolution,
                 "level_shapes": list(b.level_shapes),
                 "n_in": b.n_in,
                 "backend": b.plan.backend,
                 "table_kb": round(b.plan.value_table_bytes / 1024, 1),
                 "budget_kb": round(b.plan.staging_budget_bytes / 1024, 1),
                 "budget_source": b.plan.budget_source}
                for b in self.buckets]
