"""Row-aligned tile geometry for temporal feature-map diffing (port of
repro/stream/tiles.py).

Each pyramid level (h, w) is cut into horizontal bands of ``tile_rows``
full rows. Row alignment is what the FWP compact geometry rests on: a
row-aligned pixel window of a level maps to ONE contiguous slot range of
the compacted table, so a changed tile's slots are a contiguous scatter
target. The maps are numpy, static per (level_shapes, tile_rows); the
device copy of the pixel -> tile map is built once per device
(:func:`tile_index`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import host_constant
from repro_torch.core import fwp as fwp_lib


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Static per-level row-band tiling of the flat multi-scale fmap."""
    level_shapes: Tuple[Tuple[int, int], ...]
    tile_rows: int
    n_tiles: int
    tile_of_pixel: np.ndarray      # (N_in,) int32 pixel -> tile id
    tile_level: np.ndarray         # (n_tiles,) int32 owning level
    tile_pix_start: np.ndarray     # (n_tiles,) int32 flat start pixel
    tile_pix_count: np.ndarray     # (n_tiles,) int32 pixels in the tile

    @property
    def n_in(self) -> int:
        return int(self.tile_of_pixel.shape[0])


def tile_geometry(level_shapes: Sequence[Tuple[int, int]],
                  tile_rows: int) -> TileGeometry:
    """Cut every level into row-aligned bands of ``tile_rows`` rows."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    level_shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    starts, n_in = fwp_lib.level_starts(level_shapes)
    tile_of_pixel = np.empty((n_in,), np.int32)
    tile_level, tile_start, tile_count = [], [], []
    tid = 0
    for li, ((h, w), s) in enumerate(zip(level_shapes, starts)):
        for r0 in range(0, h, tile_rows):
            r1 = min(r0 + tile_rows, h)
            lo = int(s) + r0 * w
            hi = int(s) + r1 * w
            tile_of_pixel[lo:hi] = tid
            tile_level.append(li)
            tile_start.append(lo)
            tile_count.append(hi - lo)
            tid += 1
    return TileGeometry(
        level_shapes=level_shapes, tile_rows=int(tile_rows), n_tiles=tid,
        tile_of_pixel=tile_of_pixel,
        tile_level=np.asarray(tile_level, np.int32),
        tile_pix_start=np.asarray(tile_start, np.int32),
        tile_pix_count=np.asarray(tile_count, np.int32))


@host_constant
def _tile_index(level_shapes: Tuple[Tuple[int, int], ...], tile_rows: int,
                device: torch.device) -> torch.Tensor:
    geo = tile_geometry(level_shapes, tile_rows)
    return torch.from_numpy(geo.tile_of_pixel).to(device=device,
                                                  dtype=torch.int64)


def tile_index(geo: TileGeometry, device) -> torch.Tensor:
    """The (N_in,) int64 pixel -> tile map on ``device``, built once."""
    return _tile_index(geo.level_shapes, geo.tile_rows, torch.device(device))


def changed_tiles(geo: TileGeometry, x_new: torch.Tensor, x_ref: torch.Tensor,
                  threshold: float) -> torch.Tensor:
    """Per-tile change mask: a tile is CHANGED when the max-abs elementwise
    delta over its pixels is >= ``threshold`` (so ``threshold=0`` marks
    every tile: the parity mode). ``x_ref`` is the memory as of each
    tile's last re-projection, so sub-threshold drift accumulates until
    it crosses. Returns (B, n_tiles) bool."""
    d = (x_new - x_ref).abs().amax(dim=-1)                   # (B, N_in)
    t_of_p = tile_index(geo, d.device).expand(d.shape)
    tile_d = torch.zeros((d.shape[0], geo.n_tiles), dtype=d.dtype,
                         device=d.device)
    tile_d.scatter_reduce_(1, t_of_p, d, reduce="amax")
    return tile_d >= threshold
