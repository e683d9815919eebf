"""Windowed multi-scale-parallel MSGS + aggregation — kernel K3 of the port.

The CUDA kernel (``csrc/msgs_windowed.cu``) replaces the TPU kernel
``msgs_windowed_msp_pallas`` (``repro/kernels/msgs_windowed.py``, body
``_make_msp_kernel``). It computes the Eq. 4 aggregation of K1, but each
(batch, head-group, query-tile) step may only read the range-narrowed
window of every level that :func:`window_geometry` plans for the tile:
a corner outside the tile's pixel window, or whose compact slot lies
outside the tile's slot window, contributes nothing. The L level sums
accumulate in one pass and the int8 scale multiplies once at the end.

The window geometry is host numpy, a copy of the reference's, resolved
once per (level shapes, ranges, tile). Window starts in the compact
table come from ``searchsorted(keep_idx, pix_lo)`` on the device. The
kernel is K1's gather engine (``csrc/msgs_gather.cuh``, the same
:func:`gather_plan`) over the (q, h) items of each batch; a query finds
its tile in the table :func:`query_tiles` builds with the geometry.

:func:`msgs_windowed_msp` checks its operands and takes the plain
PyTorch version :func:`msgs_windowed_msp_plain` only when the tensors
lie on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches. The launch is the operator
``repro_torch::msgs_windowed`` (:mod:`repro_torch.kernels.library`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import host_constant
from repro_torch.kernels.library import kernel_op, on_card
from repro_torch.kernels.msgs_fused import (MAX_HEAD_DIM, TABLE_CODES,
                                            check_device, check_gather_sizes,
                                            check_remap, check_table,
                                            gather_plan,
                                            out_dtype, point_flops,
                                            pointer_alignment,
                                            raise_on_error, refuse_autograd,
                                            stream_ptr)

#: Number of CUDA kernel launches made by this module's wrappers.
LAUNCHES = 0

MAX_LEVELS = 8                   # gather::kMaxLevels in msgs_gather.cuh


# ==========================================================================
# Static window geometry (a copy of the reference's host code)
# ==========================================================================

class WindowGeometry(NamedTuple):
    """Static (numpy) per-(tile, sampled-level) window plan.

    Tiles partition the *padded* raster query axis level by level (tiles
    never straddle a query-level boundary, so every tile has one static
    reference-row span)."""
    level_shapes: Tuple[Tuple[int, int], ...]
    level_starts: Tuple[int, ...]     # flat start of each level
    tile_q: int                       # uniform query-tile size
    n_tiles: int                      # total tiles across query levels
    nq_padded: int                    # tile_q * n_tiles
    pad_offsets: Tuple[int, ...]      # per query level: start in padded axis
    tile_qlevel: np.ndarray           # (T,) query level of each tile
    pix_lo: np.ndarray                # (T, L) natural flat-pixel window start
    win_pix: np.ndarray               # (T, L) pixel-window size (rows * w_l)
    w_pix_levels: Tuple[int, ...]     # per sampled level: staged pixel
    #   window (max over tiles)
    pstart: np.ndarray                # (T, L) pix_lo clipped per level so a
    #   w_pix_levels[l] window always stays inside the flat table
    n_in: int

    def slot_windows(self, caps: Sequence[int]) -> Tuple[int, ...]:
        """Per-level compact-table slot windows: a pixel window of
        ``w_pix_levels[l]`` pixels holds at most ``min(that, cap_l)``
        slots (slots are raster-ordered per level)."""
        return tuple(min(w, int(c))
                     for w, c in zip(self.w_pix_levels, caps))

    def staged_bytes(self, lanes: int, itemsize: int,
                     caps: Optional[Sequence[int]] = None) -> int:
        """Value-window bytes the reference stages per grid step (all L
        level windows co-resident). With ``caps`` (FWP-compact): the slot
        windows of the compacted table plus the int32 ``pix2slot``
        slices."""
        if caps is None:
            return sum(self.w_pix_levels) * lanes * itemsize
        return (sum(self.slot_windows(caps)) * lanes * itemsize
                + sum(self.w_pix_levels) * 4)


@functools.lru_cache(maxsize=64)
def window_geometry(level_shapes: Tuple[Tuple[int, int], ...],
                    ranges: Tuple[float, ...],
                    tile_q: int) -> WindowGeometry:
    """Resolve the static window plan.

    For tile t (query level ql, reference rows [qr0, qr1]) sampling level
    sl, the touched rows are bounded by the pixel-centre reference mapping
    y = (r + 0.5) / h_ql * h_sl - 0.5 plus the range-narrowing bound
    R_sl, one bilinear-corner row, and one row of quantization margin."""
    starts = np.concatenate(
        [[0], np.cumsum([h * w for h, w in level_shapes])[:-1]]).astype(np.int64)
    n_in = int(sum(h * w for h, w in level_shapes))
    n_l = len(level_shapes)

    tiles = []                       # (ql, first query row, last query row)
    pad_offsets = []
    off = 0
    for ql, (h, w) in enumerate(level_shapes):
        pad_offsets.append(off)
        n = h * w
        for i in range(0, n, tile_q):
            qr0 = i // w
            qr1 = (min(i + tile_q, n) - 1) // w
            tiles.append((ql, qr0, qr1))
        off += tile_q * math.ceil(n / tile_q)
    n_tiles = len(tiles)

    pix_lo = np.zeros((n_tiles, n_l), np.int64)
    win_pix = np.zeros((n_tiles, n_l), np.int64)
    for t, (ql, qr0, qr1) in enumerate(tiles):
        h_ql = level_shapes[ql][0]
        for sl, (h_sl, w_sl) in enumerate(level_shapes):
            r_bound = float(ranges[sl])
            ymin = (qr0 + 0.5) / h_ql * h_sl - 0.5 - r_bound - 1.0
            ymax = (qr1 + 0.5) / h_ql * h_sl - 0.5 + r_bound + 1.0
            r0 = max(0, int(math.floor(ymin)))
            r1 = min(h_sl - 1, int(math.floor(ymax)) + 1)
            pix_lo[t, sl] = starts[sl] + r0 * w_sl
            win_pix[t, sl] = (r1 - r0 + 1) * w_sl
    w_pix_levels = tuple(int(w) for w in win_pix.max(axis=0))
    pstart = np.stack(
        [np.clip(pix_lo[:, l], 0, n_in - w_pix_levels[l])
         for l in range(n_l)], axis=1)
    return WindowGeometry(
        level_shapes=level_shapes, level_starts=tuple(int(s) for s in starts),
        tile_q=tile_q, n_tiles=n_tiles,
        nq_padded=tile_q * n_tiles, pad_offsets=tuple(pad_offsets),
        tile_qlevel=np.asarray([t[0] for t in tiles], np.int64),
        pix_lo=pix_lo, win_pix=win_pix, w_pix_levels=w_pix_levels,
        pstart=pstart.astype(np.int32), n_in=n_in)


def tile_spans(geo: WindowGeometry) -> Tuple[np.ndarray, np.ndarray]:
    """(first raster query, query count) of every tile, int32 (T,): the
    tiles of the raster-ordered queries, level by level (no padded copy
    of the points is made)."""
    first, count = [], []
    for ql, (h, w) in enumerate(geo.level_shapes):
        n = h * w
        for i in range(0, n, geo.tile_q):
            first.append(geo.level_starts[ql] + i)
            count.append(min(geo.tile_q, n - i))
    return np.asarray(first, np.int32), np.asarray(count, np.int32)


def query_tiles(geo: WindowGeometry) -> np.ndarray:
    """The tile of every raster query, (N_in,) int64, the table the kernel
    reads: the query's level ql is the last whose flat start is at or
    below it, and its tile the level's first (padded offset / tile_q)
    plus ``(q - start[ql]) // tile_q``."""
    q = np.arange(geo.n_in)
    starts = np.asarray(geo.level_starts)
    ql = np.searchsorted(starts, q, side="right") - 1
    first = np.asarray(geo.pad_offsets) // geo.tile_q
    return first[ql] + (q - starts[ql]) // geo.tile_q


def repack_queries(geo: WindowGeometry, arr: torch.Tensor,
                   fill=0) -> torch.Tensor:
    """Re-lay a raster-ordered (B, Nq, ...) per-query array into the
    tile-packed padded layout (B, nq_padded, ...)."""
    parts = []
    for ql, (h, w) in enumerate(geo.level_shapes):
        n = h * w
        seg = arr[:, geo.level_starts[ql]:geo.level_starts[ql] + n]
        pad = geo.tile_q * math.ceil(n / geo.tile_q) - n
        if pad:
            seg = torch.cat([seg, seg.new_full((seg.shape[0], pad)
                                               + tuple(seg.shape[2:]), fill)],
                            dim=1)
        parts.append(seg)
    return torch.cat(parts, dim=1)


def unpack_queries(geo: WindowGeometry, arr: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`repack_queries` (drops the per-level padding)."""
    parts = []
    for ql, (h, w) in enumerate(geo.level_shapes):
        off = geo.pad_offsets[ql]
        parts.append(arr[:, off:off + h * w])
    return torch.cat(parts, dim=1)


# ==========================================================================
# Window starts
# ==========================================================================

class _DeviceGeometry(NamedTuple):
    pstart: torch.Tensor       # (T, L) int32
    pix_lo: torch.Tensor       # (T * L,) int32
    dense_starts: torch.Tensor  # (1, T, L, 2) int32: pstart twice
    qtile: torch.Tensor        # (N_in,) int32: the tile of each raster query


@host_constant
def _device_geometry(level_shapes, ranges, tile_q: int,
                     device: str) -> _DeviceGeometry:
    """The geometry's arrays on ``device``, copied there once."""
    geo = window_geometry(level_shapes, ranges, tile_q)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                     device=device)
    pstart = as_t(geo.pstart)
    return _DeviceGeometry(pstart, as_t(geo.pix_lo.reshape(-1)),
                           torch.stack((pstart, pstart), -1)[None].contiguous(),
                           as_t(query_tiles(geo)))


@host_constant
def _row_limits(w_rows_v: Tuple[int, ...], n_rows: int,
                device: str) -> torch.Tensor:
    return torch.tensor([n_rows - w for w in w_rows_v], dtype=torch.int32,
                        device=device)


def window_starts(geo: WindowGeometry, dgeo: _DeviceGeometry, n_rows: int,
                  keep_idx: Optional[torch.Tensor],
                  caps: Optional[Sequence[int]]):
    """(w_rows_v, starts) as the reference computes them
    (repro/kernels/msgs_windowed.py:356-374): the per-level value-row
    window, and ``starts`` (B, T, L, 2) int32: per (batch, tile, level)
    the pixel-window start ``pstart`` and the row-window start ``vstart``
    side by side (one 8-byte load in the kernel). Compact tables start
    their rows at the first slot at or after the pixel window start,
    clipped so the window fits the table; dense tables (``keep_idx``
    None) start at ``pstart`` and ``starts`` is (1, T, L, 2)."""
    if keep_idx is None:
        return geo.w_pix_levels, dgeo.dense_starts
    w_rows_v = tuple(min(w, n_rows) for w in (
        geo.slot_windows(caps) if caps is not None else geo.w_pix_levels))
    b = keep_idx.shape[0]
    vstart = torch.searchsorted(keep_idx,
                                dgeo.pix_lo.expand(b, -1).contiguous(),
                                out_int32=True)
    vstart = vstart.view(b, geo.n_tiles, len(geo.level_shapes))
    hi = _row_limits(w_rows_v, n_rows, str(keep_idx.device))
    vstart = torch.minimum(vstart.clamp(min=0), hi)
    return w_rows_v, torch.stack((dgeo.pstart.expand(b, -1, -1), vstart), -1)


# ==========================================================================
# Plain PyTorch version
# ==========================================================================

def msgs_windowed_msp_plain(v, x_px, y_px, lvl_of_pt, probs,
                            remap: Optional[torch.Tensor] = None,
                            keep_idx: Optional[torch.Tensor] = None,
                            scale: Optional[torch.Tensor] = None, *,
                            level_shapes, ranges, tile_q: int = 128,
                            head_pack: int = 1,
                            caps: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain PyTorch version: a mirror of the reference's
    ``_make_msp_kernel`` (repro/kernels/msgs_windowed.py:195-293) over the
    tile-packed query layout. Corners are widened to float32 before
    Eq. 4, as in the kernel. Returns (B, Nq, H, Dh)."""
    b, n_rows, h, dh = v.shape
    k = x_px.shape[-1]
    use_remap = remap is not None
    geo = window_geometry(_shapes_key(level_shapes), _ranges_key(ranges),
                          int(tile_q))
    dgeo = _device_geometry(geo.level_shapes, _ranges_key(ranges), geo.tile_q,
                            str(v.device))
    w_rows_v, starts = window_starts(geo, dgeo, n_rows,
                                     keep_idx if use_remap else None, caps)
    n_t, tq = geo.n_tiles, geo.tile_q
    tiled = lambda a, fill=0: repack_queries(geo, a, fill).reshape(
        b, n_t, tq, h, k)
    x, y, p = tiled(x_px), tiled(y_px), tiled(probs)
    lvlp = tiled(lvl_of_pt, -1)                  # padding matches no level

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    t1 = (x - x0)[..., None]
    t0 = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    vflat = v.reshape(b * n_rows * h, dh)
    bidx = torch.arange(b, device=v.device).view(b, 1, 1, 1, 1)
    hidx = torch.arange(h, device=v.device).view(1, 1, 1, h, 1)
    starts = starts.long().expand(b, -1, -1, -1)  # dense: one start per tile

    acc = torch.zeros((b, n_t, tq, h, dh), dtype=torch.float32,
                      device=v.device)
    for l, (h_l, w_l) in enumerate(geo.level_shapes):
        st_l = geo.level_starts[l]
        wv = w_rows_v[l]
        wp = geo.w_pix_levels[l]
        on = lvlp == l                                   # point on level l
        p_lo = starts[:, :, l, 0].view(b, n_t, 1, 1, 1)
        s_lo = starts[:, :, l, 1].view(b, n_t, 1, 1, 1)

        def corner(dx, dy):
            cx = x0i + dx
            cy = y0i + dy
            valid = on & (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)
            pix = (st_l + torch.clamp(cy, 0, h_l - 1) * w_l
                   + torch.clamp(cx, 0, w_l - 1))
            if use_remap:
                lpix = pix - p_lo
                valid &= (lpix >= 0) & (lpix < wp)
                lpix = torch.clamp(lpix, 0, wp - 1)
                slot = torch.gather(remap.long(), 1,
                                    (p_lo + lpix).reshape(b, -1)
                                    ).reshape(lpix.shape)
                lrow = slot - s_lo                       # slot-window local
            else:
                lrow = pix - s_lo                        # pixel-window local
            valid &= (lrow >= 0) & (lrow < wv)
            row = s_lo + torch.clamp(lrow, 0, wv - 1)
            gat = vflat[((bidx * n_rows + row) * h + hidx).reshape(-1)]
            gat = gat.reshape(row.shape + (dh,)).to(torch.float32)
            return gat * valid[..., None]

        n0 = corner(0, 0)
        n1 = corner(1, 0)
        n2 = corner(0, 1)
        n3 = corner(1, 1)
        # Eq. 4 — three multiplies by the fractional coordinates:
        s = (n0 + (n2 - n0) * t0
             + ((n1 - n0) + (n3 - n2 - n1 + n0) * t0) * t1)
        acc += torch.sum(s * p[..., None], dim=4)
    acc = acc.reshape(b, geo.nq_padded, h, dh)
    if scale is not None:
        acc = acc * scale.reshape(b, 1, h, dh)   # (B, H/G, G, Dh) per head
    return unpack_queries(geo, acc).to(out_dtype(v.dtype))


# ==========================================================================
# Kernel wrapper
# ==========================================================================

def _shapes_key(level_shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in level_shapes)


def _ranges_key(ranges) -> Tuple[float, ...]:
    return tuple(float(r) for r in ranges)


def _check(v, pts, remap, keep_idx, scale, geo, head_pack, caps) -> None:
    name = "msgs_windowed"
    check_device(v.device, name)
    if v.dim() != 4:
        raise ValueError(f"{name}: table must be (B, N_rows, H, Dh), got "
                         f"{tuple(v.shape)}")
    b, n_rows, h, dh = v.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} > {MAX_HEAD_DIM}")
    if head_pack < 1 or h % head_pack:
        raise ValueError(f"{name}: head_pack {head_pack} must divide the "
                         f"head count {h}")
    check_table(v, scale, (b, h // head_pack, head_pack, dh), name)
    x = pts[0]
    for label, t, dt in zip(("x_px", "y_px", "lvl_of_pt", "probs"), pts,
                            (torch.float32, torch.float32, torch.int32,
                             torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: {label} must be {dt}, got {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != "
                             f"x_px shape {tuple(x.shape)}")
        if t.device != v.device:
            raise ValueError(f"{name}: {label} on {t.device}, table on "
                             f"{v.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.dim() != 4 or x.shape[0] != b or x.shape[2] != h:
        raise ValueError(f"{name}: points must be (B={b}, Nq, H={h}, K), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] != geo.n_in:
        raise ValueError(f"{name}: needs raster encoder queries, Nq "
                         f"{x.shape[1]} != N_in {geo.n_in}")
    if (remap is None) != (keep_idx is None):
        raise ValueError(f"{name}: a compact table needs both remap and "
                         "keep_idx; a dense table takes neither")
    check_remap(remap, b, v.device, name)
    if remap is not None:
        if remap.shape[1] != geo.n_in:
            raise ValueError(f"{name}: remap covers {remap.shape[1]} pixels, "
                             f"the pyramid {geo.n_in}")
        if keep_idx.dtype != torch.int32 or keep_idx.dim() != 2 \
                or keep_idx.shape[0] != b:
            raise ValueError(f"{name}: keep_idx must be int32 (B={b}, cap), "
                             f"got {keep_idx.dtype} {tuple(keep_idx.shape)}")
        if keep_idx.device != v.device or not keep_idx.is_contiguous():
            raise ValueError(f"{name}: keep_idx must be contiguous on "
                             f"{v.device}")
    if caps is not None and len(caps) != len(geo.level_shapes):
        raise ValueError(f"{name}: {len(caps)} capacities for "
                         f"{len(geo.level_shapes)} levels")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry ``msgs_windowed_forward`` with every argument declared:
    table code, 10 pointers (table, x, y, level, probs, remap, query
    tiles, window starts, scale, out), B, Nq, H, K, Dh, L, n_rows, n_pix, the
    starts' batch stride, the host level array, the 4 numbers of the
    gather plan and the stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("msgs_windowed").msgs_windowed_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_int64] * 3
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _fake(v, x_px, y_px, lvl_of_pt, probs, remap, scale, qtile, starts,
          levels, starts_stride):
    b, _, h, dh = v.shape
    return v.new_empty((b, x_px.shape[1], h, dh), dtype=out_dtype(v.dtype))


def _flops(v, x_px, *_, out_shape=None, **__) -> int:
    return point_flops(x_px, v[3])


@kernel_op("msgs_windowed", fake=_fake, flops=_flops)
def _launch_op(v: torch.Tensor, x_px: torch.Tensor, y_px: torch.Tensor,
               lvl_of_pt: torch.Tensor, probs: torch.Tensor,
               remap: Optional[torch.Tensor], scale: Optional[torch.Tensor],
               qtile: torch.Tensor, starts: torch.Tensor, levels: List[int],
               starts_stride: int) -> torch.Tensor:
    """``levels``: per level its height, width, flat start, pixel window
    and row window (5 L ints, field by field); ``starts_stride``: the
    starts' batch stride (0 for a dense table's shared starts)."""
    global LAUNCHES
    b, n_rows, h, dh = v.shape
    _, nq, _, k = x_px.shape
    n_l = len(levels) // 5
    out = torch.empty((b, nq, h, dh), dtype=out_dtype(v.dtype), device=v.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    n_pix = 0 if remap is None else remap.shape[1]
    check_gather_sizes(nq * h, h * dh * v.element_size(), "msgs_windowed")
    plan = gather_plan(dh, v.element_size(), pointer_alignment(v))
    with torch.cuda.device(v.device):
        code = _entry()(
            TABLE_CODES[v.dtype], ptr(v), ptr(x_px), ptr(y_px), ptr(lvl_of_pt),
            ptr(probs), ptr(remap), ptr(qtile), ptr(starts), ptr(scale),
            ptr(out), b, nq, h, k, dh, n_l, n_rows, n_pix, starts_stride,
            (ctypes.c_int * len(levels))(*levels),
            plan.vec_bytes, plan.group_lanes, plan.lanes_per_row,
            plan.row_chunks, stream_ptr(v.device))
    LAUNCHES += 1
    raise_on_error(code, "msgs_windowed")
    return out


def _launch(v, pts, remap, scale, geo, dgeo, w_rows_v,
            starts) -> torch.Tensor:
    n_l = len(geo.level_shapes)
    if n_l > MAX_LEVELS:
        raise ValueError(f"msgs_windowed: {n_l} levels > {MAX_LEVELS}")
    levels = [*[hh for hh, _ in geo.level_shapes],
              *[ww for _, ww in geo.level_shapes],
              *geo.level_starts, *geo.w_pix_levels, *w_rows_v]
    return _launch_op(v, *pts, remap, scale, dgeo.qtile, starts,
                      [int(x) for x in levels],
                      0 if starts.shape[0] == 1 else geo.n_tiles * n_l)


def msgs_windowed_msp(v, x_px, y_px, lvl_of_pt, probs,
                      remap: Optional[torch.Tensor] = None,
                      keep_idx: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None, *,
                      level_shapes, ranges, tile_q: int = 128,
                      head_pack: int = 1,
                      caps: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Single-launch multi-scale-parallel windowed MSGS + fused level
    aggregation over ``v (B, N_rows, H, Dh)``.

    Points ``(B, N_in, H, K)`` in raster encoder order: x/y/probs float32,
    ``lvl_of_pt`` int32. ``remap (B, N_in)`` and ``keep_idx (B, cap)``
    int32 together select the FWP-compact table (``caps`` bounds its slot
    windows); ``scale (B, H/G, G, Dh)`` float32 with an int8 table.
    Returns (B, N_in, H, Dh) in the table dtype (float32 for int8). CUDA
    tensors launch the kernel; CPU tensors run the plain version; under
    autograd it raises, as the forward-only K1 does."""
    refuse_autograd("msgs_windowed_msp", v, x_px, y_px, probs, scale)
    pts = (x_px, y_px, lvl_of_pt, probs)
    shapes, rngs = _shapes_key(level_shapes), _ranges_key(ranges)
    geo = window_geometry(shapes, rngs, int(tile_q))
    _check(v, pts, remap, keep_idx, scale, geo, head_pack, caps)
    if not on_card(v):
        return msgs_windowed_msp_plain(
            v, *pts, remap=remap, keep_idx=keep_idx, scale=scale,
            level_shapes=shapes, ranges=rngs, tile_q=tile_q,
            head_pack=head_pack, caps=caps)
    dgeo = _device_geometry(shapes, rngs, geo.tile_q, str(v.device))
    w_rows_v, starts = window_starts(geo, dgeo, v.shape[1], keep_idx, caps)
    return _launch(v, pts, remap, scale, geo, dgeo, w_rows_v, starts)
