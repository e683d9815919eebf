"""Synthetic drifting-scene video (port of repro/stream/synthetic.py).

Encoder-memory frames (B, N_in, D) of a static per-level background plus
a band of ``obj_rows`` rows per level that moves down ``speed_rows`` rows
per frame (wrapping), with optional background noise. Frame to frame
only the rows the object left and entered change, a few row-aligned
tiles. numpy, with the reference's generator calls in the reference's
order, so one seed gives the reference's frames bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import fwp as fwp_lib


def drifting_scene(seed: int, level_shapes: Sequence[Tuple[int, int]],
                   d_model: int, n_frames: int, *, batch: int = 1,
                   obj_rows: int = 1, speed_rows: int = 1,
                   amplitude: float = 2.0, noise: float = 0.0
                   ) -> List[np.ndarray]:
    """Generate ``n_frames`` memories (B, N_in, D) of a drifting scene."""
    rng = np.random.default_rng(seed)
    starts, n_in = fwp_lib.level_starts(level_shapes)
    bg = rng.standard_normal((batch, n_in, d_model)).astype(np.float32)
    blobs = [rng.standard_normal((batch, obj_rows * w, d_model))
             .astype(np.float32) for h, w in level_shapes]
    frames = []
    for t in range(n_frames):
        x = bg.copy()
        if noise > 0.0:
            x += (noise * rng.standard_normal(x.shape)).astype(np.float32)
        for (h, w), s, blob in zip(level_shapes, starts, blobs):
            span = max(1, h - obj_rows + 1)
            r = (t * speed_rows) % span
            lo = int(s) + r * w
            x[:, lo:lo + obj_rows * w] += amplitude * blob
        frames.append(x)
    return frames
