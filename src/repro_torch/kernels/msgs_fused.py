"""Fused MSGS (bilinear grid-sampling) + aggregation — kernel K1 of the port.

The CUDA kernel (``csrc/msgs_fused.cu``) replaces the TPU kernels
``msgs_fused_pallas`` and ``msgs_fused_packed_pallas``
(``repro/kernels/msgs_fused.py``). Per (b, q, h) it sums, over the K
points, p_k times the Eq. 4 factorised bilinear sample of the 4 corner
rows of ``v (B, N_rows, H, Dh)`` inside the point's level; out-of-level
corners are zero, the optional ``remap`` sends pruned pixels to the zero
sentinel row, and an int8 table's per-channel ``scale`` multiplies once
after aggregation.

:func:`msgs_fused` and :func:`msgs_fused_packed` check their operands
and then take the plain PyTorch version :func:`msgs_fused_plain` only
when the tensors lie on the CPU; for CUDA tensors they launch the kernel
or raise. ``LAUNCHES`` counts kernel launches.

The kernel is the gather engine of ``csrc/msgs_gather.cuh``, shared with
K2 and K3: :func:`gather_plan` says how the lanes of a warp cover a table row
(vector width, lanes per item, items per warp).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

#: Number of CUDA kernel launches made by this module's wrappers.
LAUNCHES = 0

#: table dtype -> the C entry's ``table_dtype`` code
TABLE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 128               # the widest head the wrappers accept

#: the gather engine's launch constants (csrc/msgs_gather.cuh)
WARP = 32
WARPS_PER_BLOCK = 4              # gather::kWarps
MIN_BLOCKS_PER_SM = 8            # gather::kMinBlocks, in __launch_bounds__
POINTS_PER_PASS = 4              # gather::kPass: an item's points in flight together
VECTOR_WIDTHS = (16, 8, 4, 2, 1)  # bytes one lane loads from a row


def out_dtype(table_dtype: torch.dtype) -> torch.dtype:
    """int8 codes aggregate to float32; float tables keep their dtype."""
    return torch.float32 if table_dtype == torch.int8 else table_dtype


def check_table(v: torch.Tensor, scale: Optional[torch.Tensor],
                scale_shape: Sequence[int], name: str) -> None:
    if v.dtype not in TABLE_CODES:
        raise TypeError(f"{name}: table dtype {v.dtype} unsupported; "
                        f"expected one of {list(TABLE_CODES)}")
    if (v.dtype == torch.int8) != (scale is not None):
        raise ValueError(f"{name}: an int8 table needs its float32 scale and "
                         "a float table takes none")
    if scale is not None:
        if scale.dtype != torch.float32 or tuple(scale.shape) != tuple(scale_shape):
            raise ValueError(f"{name}: scale must be float32 {tuple(scale_shape)}, "
                             f"got {scale.dtype} {tuple(scale.shape)}")
        if scale.device != v.device or not scale.is_contiguous():
            raise ValueError(f"{name}: scale must be contiguous on {v.device}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")


def check_points(pts: Sequence[torch.Tensor], device: torch.device,
                 name: str) -> None:
    """x, y, start, wl, hl, probs: one shape, f32 / int32, contiguous."""
    x = pts[0]
    for label, t, dt in zip(("x_px", "y_px", "start", "wl", "hl", "probs"), pts,
                            (torch.float32, torch.float32, torch.int32,
                             torch.int32, torch.int32, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: {label} must be {dt}, got {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != "
                             f"x_px shape {tuple(x.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {label} on {t.device}, table on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def check_remap(remap: Optional[torch.Tensor], b: int, device: torch.device,
                name: str) -> None:
    if remap is None:
        return
    if remap.dtype != torch.int32 or remap.dim() != 2 or remap.shape[0] != b:
        raise ValueError(f"{name}: remap must be int32 (B={b}, N_pix), got "
                         f"{remap.dtype} {tuple(remap.shape)}")
    if remap.device != device or not remap.is_contiguous():
        raise ValueError(f"{name}: remap must be contiguous on {device}")


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Forward-only kernels (K1, K3) raise under autograd instead of
    returning an output with no gradient path: the reference's
    ``pallas_call`` has no autodiff rule either, and raises under
    ``jax.grad`` even in interpret mode. Checked on both devices, so the
    CPU shows what the card does."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only and cannot be differentiated; train "
            "through the differentiable torch_gather backend (or "
            "cuda_decode in the decoder)")


def check_device(device: torch.device, name: str) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {device}; expected cuda (the "
                         "kernel) or cpu (the plain version)")


def _check(v, pts, remap, scale) -> None:
    name = "msgs_fused"
    check_device(v.device, name)
    if v.dim() != 4:
        raise ValueError(f"{name}: table must be (B, N_rows, H, Dh), got "
                         f"{tuple(v.shape)}")
    b, _, h, dh = v.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} > {MAX_HEAD_DIM}")
    check_table(v, scale, (b, 1, h, dh), name)
    check_points(pts, v.device, name)
    x = pts[0]
    if x.dim() != 4 or x.shape[0] != b or x.shape[2] != h:
        raise ValueError(f"{name}: points must be (B={b}, Nq, H={h}, K), got "
                         f"{tuple(x.shape)}")
    check_remap(remap, b, v.device, name)


def msgs_fused_plain(v, x_px, y_px, start, wl, hl, probs,
                     remap: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: a batched mirror of the reference's
    ``_eq4_sample_agg`` (repro/kernels/msgs_fused.py:40-87). Corners are
    widened to float32 before Eq. 4, as in the kernel (the reference
    subtracts bf16 corners in bf16). Returns (B, Nq, H, Dh)."""
    b, n_rows, h, dh = v.shape
    x0 = torch.floor(x_px)
    y0 = torch.floor(y_px)
    t1 = (x_px - x0)[..., None]
    t0 = (y_px - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    vflat = v.reshape(b * n_rows * h, dh)
    bidx = torch.arange(b, device=v.device).view(b, 1, 1, 1)
    hidx = torch.arange(h, device=v.device).view(1, 1, h, 1)

    def corner(dx, dy):
        cx = x0i + dx
        cy = y0i + dy
        valid = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
        idx = start + torch.minimum(torch.clamp(cy, min=0), hl - 1) * wl \
            + torch.minimum(torch.clamp(cx, min=0), wl - 1)
        if remap is not None:
            idx = torch.gather(remap.long(), 1, idx.reshape(b, -1)
                               ).reshape(idx.shape)
        g = vflat[((bidx * n_rows + idx) * h + hidx).reshape(-1)]
        g = g.reshape(idx.shape + (dh,)).to(torch.float32)
        return g * valid[..., None]

    n0 = corner(0, 0)
    n1 = corner(1, 0)
    n2 = corner(0, 1)
    n3 = corner(1, 1)
    s = n0 + (n2 - n0) * t0 + ((n1 - n0) + (n3 - n2 - n1 + n0) * t0) * t1
    out = torch.sum(s * probs[..., None], dim=3)
    if scale is not None:
        return out * scale
    return out.to(out_dtype(v.dtype))


class GatherPlan(NamedTuple):
    """How the lanes of a warp cover one table row of ``dh`` channels."""
    vec_bytes: int        # bytes one lane loads per row (the VEC template)
    lanes_per_row: int    # row bytes / vec_bytes
    group_lanes: int      # lanes serving one item: a power of two <= 32
    items_per_warp: int   # 32 // group_lanes
    row_chunks: int       # passes over a row wider than the group
    channels_per_lane: int  # vec_bytes // itemsize, per pass


def gather_plan(dh: int, itemsize: int, align: int = 16,
                stride: Optional[int] = None) -> GatherPlan:
    """The widest vector (16 B at most) that divides the row's bytes, the
    stride between one head's rows (``stride`` elements, default ``dh``;
    K2's staged table: ``head_pack * dh``) and the table pointer's
    alignment ``align``, so that every row of every head starts on a
    vector; lanes per row; the smallest power-of-two lane group that holds
    them (at most a warp, the rest in ``row_chunks`` passes)."""
    row = dh * itemsize
    step = (dh if stride is None else stride) * itemsize
    vec = next(w for w in VECTOR_WIDTHS
               if w >= itemsize and row % w == 0 and step % w == 0
               and align % w == 0)
    lanes = row // vec
    group = min(WARP, 1 << (lanes - 1).bit_length())
    return GatherPlan(vec, lanes, group, WARP // group, -(-lanes // group),
                      vec // itemsize)


def pointer_alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides ``t``'s address."""
    ptr = t.data_ptr()
    return 16 if ptr % 16 == 0 else ptr & -ptr


#: the kernels count a batch's (Nq, H) items and the bytes of one table row
#: of H heads in 31 bits (8.6 GB per point array and batch, 2 GB per row)
MAX_BATCH_ITEMS = 2 ** 31 - WARPS_PER_BLOCK * WARP - 1
MAX_TABLE_ROW_BYTES = 2 ** 31 - 1


def check_gather_sizes(per_batch: int, table_row_bytes: int, name: str) -> None:
    if per_batch > MAX_BATCH_ITEMS or table_row_bytes > MAX_TABLE_ROW_BYTES:
        raise ValueError(f"{name}: {per_batch} (query, head) items per batch "
                         f"and {table_row_bytes} B table rows; the kernel "
                         f"counts at most {MAX_BATCH_ITEMS} and "
                         f"{MAX_TABLE_ROW_BYTES}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card that holds ``device``: what
    K4's and K5's launch plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def raise_on_error(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry ``msgs_fused_forward`` with every argument declared:
    table code, 10 pointers (table, 6 point operands, remap, scale, out),
    B, Nq, H, K, Dh, n_rows, n_pix, the 4 numbers of the gather plan and
    the stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("msgs_fused").msgs_fused_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(v, x_px, y_px, start, wl, hl, probs, remap, scale) -> torch.Tensor:
    global LAUNCHES
    b, n_rows, h, dh = v.shape
    _, nq, _, k = x_px.shape
    out = torch.empty((b, nq, h, dh), dtype=out_dtype(v.dtype), device=v.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    n_pix = 0 if remap is None else remap.shape[1]
    check_gather_sizes(nq * h, h * dh * v.element_size(), "msgs_fused")
    plan = gather_plan(dh, v.element_size(), pointer_alignment(v))
    with torch.cuda.device(v.device):
        code = _entry()(
            TABLE_CODES[v.dtype], ptr(v), ptr(x_px), ptr(y_px), ptr(start),
            ptr(wl), ptr(hl), ptr(probs), ptr(remap), ptr(scale), ptr(out),
            b, nq, h, k, dh, n_rows, n_pix, plan.vec_bytes, plan.group_lanes,
            plan.lanes_per_row, plan.row_chunks, stream_ptr(v.device))
    LAUNCHES += 1
    raise_on_error(code, "msgs_fused")
    return out


def msgs_fused(v, x_px, y_px, start, wl, hl, probs,
               remap: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused grid-sample + aggregation over ``v (B, N_rows, H, Dh)``.

    Points ``(B, Nq, H, K)``: x/y/probs float32, start/wl/hl int32;
    ``remap (B, N_pix)`` int32; ``scale (B, 1, H, Dh)`` float32 with an
    int8 table. Returns (B, Nq, H, Dh) in the table dtype (float32 for
    int8). CUDA tensors launch the kernel; CPU tensors run the plain
    version; under autograd it raises (:func:`refuse_autograd`). The
    caller guarantees indices in range: ``start + wl * hl``
    within the pixel axis and every ``remap`` value below N_rows."""
    pts = (x_px, y_px, start, wl, hl, probs)
    refuse_autograd("msgs_fused", v, x_px, y_px, probs, scale)
    _check(v, pts, remap, scale)
    if v.device.type == "cpu":
        return msgs_fused_plain(v, *pts, remap=remap, scale=scale)
    return _launch(v, *pts, remap, scale)


def msgs_fused_packed(v, x_px, y_px, start, wl, hl, probs,
                      remap: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None, *,
                      head_pack: int = 4) -> torch.Tensor:
    """The reference's head-packed entry point. Packing ``head_pack``
    heads per 128-lane row is a TPU layout; on the H100 it is the same
    kernel as :func:`msgs_fused`."""
    if head_pack < 1 or v.shape[2] % head_pack:
        raise ValueError(f"msgs_fused_packed: head_pack {head_pack} must "
                         f"divide the head count {v.shape[2]}")
    return msgs_fused(v, x_px, y_px, start, wl, hl, probs, remap=remap,
                      scale=scale)
