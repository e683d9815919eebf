"""Assigned input-shape set (one per cell of the arch × shape matrix); a
copy of ``repro/configs/shapes.py``.

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV/
state cache of seq_len), not ``train_step``. ``long_500k`` requires
sub-quadratic attention — run for SSM/hybrid, skipped for pure
full-attention archs (recorded in DESIGN.md §Arch-applicability)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# families whose decode cost is sub-quadratic in context (SSM state and/or
# sliding-window attention) — the only ones long_500k applies to
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shapes_for(family: str) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if family in LONG_CONTEXT_FAMILIES:
        names.append("long_500k")
    return names
