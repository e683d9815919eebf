"""Persistent-cache decode MSGS + aggregation — kernel K2 of the port.

The CUDA kernel (``csrc/msgs_decode.cu``) replaces the TPU kernel
``_decode_pallas_call`` (``repro/kernels/msgs_decode.py``), behind
``msgs_decode_pallas`` (one layer) and ``msgs_decode_layers_pallas``
(L stacked layers in one launch); forward only — the backward waits for
the training slice.

:func:`stage_decode_table` lays the (B, N_rows, H, Dh) table out ONCE per
memory in the decode launch layout (B, H/G, N_rows, G·Dh) — ``G =
head_pack`` heads side by side per row — bit-identical to the
reference's staged table; it is a reshape and a transpose. Every decoder
layer's launch then samples the staged table. :func:`msgs_decode` and
:func:`msgs_decode_layers` take the plain version :func:`msgs_decode_plain`
only for tensors on the CPU; CUDA tensors launch the kernel or raise.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels.msgs_fused import (MAX_HEAD_DIM, TABLE_CODES,
                                            check_device, check_points,
                                            check_remap, check_table,
                                            out_dtype, raise_on_error,
                                            stream_ptr)

#: Number of CUDA kernel launches made by this module's wrappers.
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class DecodeStagedTable:
    """The once-per-memory staged value table in decode launch layout."""
    v: torch.Tensor                     # (B, n_groups, N_rows, G*Dh)
    remap: Optional[torch.Tensor]       # (B, N_pix) int32 or None
    n_rows: int
    head_pack: int
    dh: int
    table_bytes: int                    # bytes per (batch, head-group)
    scale: Optional[torch.Tensor] = None  # (B, n_groups, G*Dh) f32 for int8


def stage_decode_table(v: torch.Tensor, remap: Optional[torch.Tensor] = None,
                       *, head_pack: int = 1,
                       scale: Optional[torch.Tensor] = None) -> DecodeStagedTable:
    """(B, N_rows, H, Dh) -> (B, H/G, N_rows, G·Dh), plus the int8 table's
    (B, 1, H, Dh) scale packed into the same per-group layout."""
    b, n_rows, h, dh = v.shape
    g = head_pack if (head_pack > 1 and h % head_pack == 0) else 1
    vp = v.reshape(b, n_rows, h // g, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, h // g, n_rows, g * dh)
    table_bytes = n_rows * g * dh * v.element_size()
    if remap is not None:
        table_bytes += remap.shape[-1] * 4
    sp = None
    if scale is not None:
        sp = scale.reshape(b, h // g, g * dh).to(torch.float32).contiguous()
        table_bytes += g * dh * 4
    return DecodeStagedTable(v=vp.contiguous(), remap=remap, scale=sp,
                             n_rows=n_rows, head_pack=g, dh=dh,
                             table_bytes=table_bytes)


def msgs_decode_plain(vp, x_px, y_px, start, wl, hl, probs, remap=None,
                      scale=None, *, head_pack: int, dh: int) -> torch.Tensor:
    """Plain PyTorch version over the staged layout: a mirror of the
    reference's ``msgs_decode_ref`` (repro/kernels/msgs_decode.py:294-318)
    — un-stage, dequantize up front, flat corner gather with bilinear
    weights. Points (B, L, Nq, H, K) -> (B, L, Nq, H, Dh)."""
    from repro_torch.msda.sampling import corner_data, flat_gather_heads
    b, n_groups, n_rows, _ = vp.shape
    _, n_layers, nq, h, k = x_px.shape
    if scale is not None:
        vp = vp.to(probs.dtype) * scale[:, :, None, :].to(probs.dtype)
    v4 = vp.reshape(b, n_groups, n_rows, head_pack, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, n_rows, h, dh)
    idx, wgt, valid = corner_data(x_px, y_px, wl, hl, start)
    idx = idx.reshape(b, n_layers * nq, h, k * 4)
    if remap is not None:
        idx = torch.gather(remap, 1, idx.reshape(b, -1).long()).reshape(idx.shape)
    eff_w = (wgt * valid.to(wgt.dtype) * probs[..., None]) \
        .reshape(b, n_layers * nq, h, k * 4)
    g = flat_gather_heads(v4, idx)
    out = torch.sum(g * eff_w[..., None], dim=3)
    return out.reshape(b, n_layers, nq, h, dh).to(
        torch.float32 if scale is not None else out_dtype(vp.dtype))


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry ``msgs_decode_forward`` with every argument declared:
    table code, 10 pointers (staged table, 6 point operands, remap, scale,
    out), B, L, Nq, H, K, Dh, G, n_rows, n_pix and the stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("msgs_decode").msgs_decode_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 7 + [ctypes.c_int64] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(staged: DecodeStagedTable, pts) -> None:
    name = "msgs_decode"
    vp = staged.v
    check_device(vp.device, name)
    if vp.dim() != 4:
        raise ValueError(f"{name}: staged table must be (B, H/G, N_rows, G*Dh), "
                         f"got {tuple(vp.shape)}")
    b, n_groups, n_rows, gdh = vp.shape
    g, dh = staged.head_pack, staged.dh
    if gdh != g * dh or n_rows != staged.n_rows:
        raise ValueError(f"{name}: staged table {tuple(vp.shape)} does not "
                         f"match head_pack={g}, dh={dh}, n_rows={staged.n_rows}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} > {MAX_HEAD_DIM}")
    check_table(vp, staged.scale, (b, n_groups, gdh), name)
    check_points(pts, vp.device, name)
    x = pts[0]
    if x.dim() != 5 or x.shape[0] != b or x.shape[3] != n_groups * g:
        raise ValueError(f"{name}: points must be (B={b}, L, Nq, "
                         f"H={n_groups * g}, K), got {tuple(x.shape)}")
    check_remap(staged.remap, b, vp.device, name)


def _launch(staged: DecodeStagedTable, x_px, y_px, start, wl, hl,
            probs) -> torch.Tensor:
    global LAUNCHES
    vp, remap, scale = staged.v, staged.remap, staged.scale
    b, _, n_rows, _ = vp.shape
    _, n_layers, nq, h, k = x_px.shape
    out = torch.empty((b, n_layers, nq, h, staged.dh),
                      dtype=out_dtype(vp.dtype), device=vp.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    n_pix = 0 if remap is None else remap.shape[1]
    with torch.cuda.device(vp.device):
        code = _entry()(
            TABLE_CODES[vp.dtype], ptr(vp), ptr(x_px), ptr(y_px), ptr(start),
            ptr(wl), ptr(hl), ptr(probs), ptr(remap), ptr(scale), ptr(out),
            b, n_layers, nq, h, k, staged.dh, staged.head_pack, n_rows, n_pix,
            stream_ptr(vp.device))
    LAUNCHES += 1
    raise_on_error(code, "msgs_decode")
    return out


def msgs_decode_layers(staged: DecodeStagedTable, x_px, y_px, start, wl, hl,
                       probs) -> torch.Tensor:
    """Stacked multi-layer decode: ONE launch samples the staged table for
    all layers' points ``(B, L, Nq, H, K)``. Returns (B, L, Nq, H, Dh)."""
    pts = (x_px, y_px, start, wl, hl, probs)
    _check(staged, pts)
    if staged.v.device.type == "cpu":
        return msgs_decode_plain(staged.v, *pts, staged.remap, staged.scale,
                                 head_pack=staged.head_pack, dh=staged.dh)
    return _launch(staged, *pts)


def msgs_decode(staged: DecodeStagedTable, x_px, y_px, start, wl, hl,
                probs) -> torch.Tensor:
    """Per-layer decode launch (the decoder path: layer l's coordinates
    exist only after layer l-1). Points (B, Nq, H, K) -> (B, Nq, H, Dh)."""
    add_l = lambda a: a[:, None]
    return msgs_decode_layers(staged, add_l(x_px), add_l(y_px), add_l(start),
                              add_l(wl), add_l(hl), add_l(probs))[:, 0]
