"""Cache-local query ordering (port of repro/msda/ordering.py).

The decode kernel's staging economics rest on adjacent queries of a tile
sharing table rows: per-level slot ranges are raster-ordered
(``core/fwp.py``), so the rows a query tile reads are set by the
reference-point spread of the tile. Encoder queries arrive raster-ordered;
decoder queries arrive in learned order, so one tile can span the whole
image. This module computes a permutation over queries from their
reference points, applied before sampling and inverted on the output:

  * ``raster`` — sort by flat pixel index on the dominant level (the
    largest h*w);
  * ``zorder`` — sort by the Morton code of the point quantized to a
    2^10 grid per axis, which keeps both the row span and the column
    spread of a tile bounded.

Every per-query op of the MSDA pass is row-independent, so
``invert(perm, f(permute(perm, x))) == f(x)`` holds bitwise. The policy
is ``MSDeformAttnConfig.query_order`` in {"none", "raster", "zorder"}:
argument > config field > ``REPRO_MSDA_QUERY_ORDER`` > ``"none"``.
Raster-only backends (``cuda_windowed``) keep their queries unpermuted:
their tile -> window geometry derives from raster query position.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fwp as fwp_lib

__all__ = [
    "QUERY_ORDERS", "resolve_query_order", "dominant_level",
    "query_sort_keys", "query_permutation", "permute_queries",
    "invert_queries", "tile_window_stats",
]

#: The recognised ordering policies.
QUERY_ORDERS = ("none", "raster", "zorder")

#: Morton quantization grid: 2^10 cells per axis, so the interleaved key
#: fits in 20 bits of an int32.
_MORTON_BITS = 10


def resolve_query_order(cfg, override: Optional[str] = None) -> str:
    """Precedence: ``override`` > ``cfg.query_order`` >
    ``REPRO_MSDA_QUERY_ORDER`` > ``"none"``."""
    choice = override
    if choice is None:
        choice = getattr(cfg, "query_order", None)
    if choice is None:
        choice = os.environ.get("REPRO_MSDA_QUERY_ORDER") or None
    if choice is None:
        return "none"
    if choice not in QUERY_ORDERS:
        raise ValueError(
            f"unsupported MSDA query order {choice!r}; "
            f"supported: {QUERY_ORDERS}")
    return choice


def dominant_level(level_shapes: Sequence[Tuple[int, int]]) -> int:
    """Index of the level with the largest h*w."""
    return int(np.argmax([h * w for h, w in level_shapes]))


def _interleave_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low ``_MORTON_BITS`` bits of ``v`` (int32, >= 0) so bit
    i lands at position 2i; every intermediate stays below 2^31."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def query_sort_keys(ref_points: torch.Tensor,
                    level_shapes: Sequence[Tuple[int, int]],
                    method: str) -> torch.Tensor:
    """(..., Nq, 2) normalized (x, y) -> (..., Nq) int32 keys: the raster
    index on the dominant level, or the Morton code of the quantized
    point. The float -> int conversion truncates toward zero, as the
    reference's ``astype(int32)`` does."""
    if method == "raster":
        h, w = level_shapes[dominant_level(level_shapes)]
        px = torch.clamp((ref_points[..., 0] * w).to(torch.int32), 0, w - 1)
        py = torch.clamp((ref_points[..., 1] * h).to(torch.int32), 0, h - 1)
        return py * w + px
    if method == "zorder":
        n = 1 << _MORTON_BITS
        qx = torch.clamp((ref_points[..., 0] * n).to(torch.int32), 0, n - 1)
        qy = torch.clamp((ref_points[..., 1] * n).to(torch.int32), 0, n - 1)
        return (_interleave_bits(qy) << 1) | _interleave_bits(qx)
    raise ValueError(f"unknown query order {method!r} "
                     f"(expected one of {QUERY_ORDERS[1:]})")


def query_permutation(ref_points: torch.Tensor,
                      level_shapes: Sequence[Tuple[int, int]],
                      method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv_perm), both (..., Nq) int32, from a stable sort of the
    keys: ``sorted_x = take(x, perm)`` and ``x == take(sorted_x, inv)``."""
    keys = query_sort_keys(ref_points, level_shapes, method)
    perm = torch.argsort(keys, dim=-1, stable=True)
    inv = torch.argsort(perm, dim=-1, stable=True)
    return perm.to(torch.int32), inv.to(torch.int32)


def _take_queries(arr: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather along the query axis (axis 1) of a (B, Nq, ...) tensor with
    a (B, Nq) permutation broadcast over the trailing dims."""
    idx = perm.long().reshape(perm.shape + (1,) * (arr.dim() - perm.dim()))
    return torch.gather(arr, 1, idx.expand(arr.shape))


def permute_queries(arr: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder a (B, Nq, ...) tensor into sorted query order."""
    return _take_queries(arr, perm)


def invert_queries(arr: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """Undo :func:`permute_queries` on a (B, Nq, ...) output."""
    return _take_queries(arr, inv_perm)


def tile_window_stats(ref_points,
                      level_shapes: Sequence[Tuple[int, int]],
                      ranges: Sequence[float],
                      tile_q: int,
                      lanes: int,
                      itemsize: int,
                      *,
                      order: str = "none",
                      capacity: Optional[float] = None) -> dict:
    """Measured window bytes per query tile for a concrete query set, on
    the host.

    For each tile of ``tile_q`` consecutive queries (in ``order``) and
    each level, the row window spans ``ref_y*h - 0.5 ± (R + 1)`` plus the
    bilinear lower corner, times the level width. A tile's bytes sum its
    per-level windows (compact: the capacity-clamped slot window plus
    the int32 pix2slot window slice). ``ref_points``: (Nq, 2) or
    (B, Nq, 2), batch 0 measured. Returns ``{"order", "n_tiles",
    "max_bytes", "mean_bytes"}``."""
    refs = np.asarray(ref_points, np.float64)
    if refs.ndim == 3:
        refs = refs[0]
    nq = refs.shape[0]
    if order != "none":
        keys = query_sort_keys(torch.from_numpy(refs.astype(np.float32)),
                               level_shapes, order).numpy()
        refs = refs[np.argsort(keys, kind="stable")]
    caps = None
    if capacity is not None:
        caps = fwp_lib.level_capacities(level_shapes, capacity)

    n_tiles = max(1, -(-nq // tile_q))
    tile_bytes = np.zeros(n_tiles, np.int64)
    for t in range(n_tiles):
        chunk = refs[t * tile_q:(t + 1) * tile_q]
        for li, (h, w) in enumerate(level_shapes):
            r = float(ranges[li])
            y = chunk[:, 1] * h - 0.5
            r0 = max(0, int(np.floor(float(np.min(y)) - r - 1.0)))
            r1 = min(h - 1, int(np.floor(float(np.max(y)) + r + 1.0)) + 1)
            win_pix = (r1 - r0 + 1) * w
            if caps is None:
                tile_bytes[t] += win_pix * lanes * itemsize
            else:
                slot_win = min(win_pix, caps[li])
                tile_bytes[t] += slot_win * lanes * itemsize + win_pix * 4
    return {"order": order, "n_tiles": n_tiles,
            "max_bytes": int(tile_bytes.max()),
            "mean_bytes": float(tile_bytes.mean())}
