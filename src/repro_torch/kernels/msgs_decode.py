"""Persistent-cache decode MSGS + aggregation — kernel K2 of the port,
forward and backward.

The CUDA kernels replace the TPU kernel ``_decode_pallas_call``
(``repro/kernels/msgs_decode.py``), behind ``msgs_decode_pallas`` (one
layer) and ``msgs_decode_layers_pallas`` (L stacked layers in one
launch), and its ``jax.custom_vjp`` backward ``_msgs_decode_bwd``, which
is ``jax.vjp`` of ``msgs_decode_ref``: ``csrc/msgs_decode.cu`` samples
through the gather engine of K1 and K3 (``csrc/msgs_gather.cuh``, with
the staged table's row stride), ``csrc/msgs_decode_bwd.cu``
differentiates. The backward is deterministic: per tile of one (b, h)
plane's items its corners are sorted by row (stable) and each row's
terms summed in slot order, then the tiles' partials of a row are added
in tile order and every row of d_vp is written once (no zero fill, no
atomics); the int8 scale gradient is an ordered sum of per-tile
partials. Repeated on the same operands it gives bitwise-equal outputs.

:func:`stage_decode_table` lays the (B, N_rows, H, Dh) table out ONCE per
memory in the decode launch layout (B, H/G, N_rows, G·Dh) — ``G =
head_pack`` heads side by side per row — bit-identical to the
reference's staged table; it is a reshape and a transpose, so the staged
table's gradient flows back into the value projection through autograd.
Every decoder layer's launch then samples the staged table.
:func:`update_staged_rows` rewrites rows of a staged table in place (the
streaming path). :func:`msgs_decode` and :func:`msgs_decode_layers` go
through :class:`MsgsDecode`, a ``torch.autograd.Function``: on CUDA
tensors it launches the forward kernel and, in the backward pass, the
backward kernel; on CPU tensors it takes the plain versions
:func:`msgs_decode_plain` and :func:`msgs_decode_backward_plain`.
``LAUNCHES`` and ``LAUNCHES_BWD`` count the two kernels' launches. The
launches are the operators ``repro_torch::msgs_decode`` and
``repro_torch::msgs_decode_backward`` (:mod:`repro_torch.kernels.library`);
the staging is a reshape and a copy, traced as it is.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.library import kernel_op, no_tensor, numel, on_card
from repro_torch.kernels.msgs_fused import (MAX_HEAD_DIM, TABLE_CODES,
                                            GatherPlan, point_flops,
                                            check_device, check_gather_sizes,
                                            check_points, check_remap,
                                            check_table, gather_plan,
                                            out_dtype, pointer_alignment,
                                            raise_on_error, stream_ptr)

#: Number of forward kernel launches made by this module's wrappers.
LAUNCHES = 0
#: Number of backward kernel launches made by this module's wrappers.
LAUNCHES_BWD = 0

#: K2 backward per channel: <v_c, g> (multiply, add) for every valid corner
#: of every point, and p w_c g (multiply) plus its add into the row's sum
#: for every valid corner of a live point.
FLOPS_PER_CHANNEL_CORNER_DOT = 2
FLOPS_PER_CHANNEL_CORNER_SCATTER = 2


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


def _stage_layout(v: torch.Tensor, g: int) -> torch.Tensor:
    """(B, N_rows, H, Dh) -> (B, H/G, N_rows, G·Dh)."""
    b, n_rows, h, dh = v.shape
    return v.reshape(b, n_rows, h // g, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, h // g, n_rows, g * dh)


def _unstage_layout(vp: torch.Tensor, g: int, dh: int) -> torch.Tensor:
    """(B, H/G, N_rows, G·Dh) -> (B, N_rows, H, Dh)."""
    b, n_groups, n_rows, _ = vp.shape
    return vp.reshape(b, n_groups, n_rows, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, n_rows, n_groups * g, dh)


def stage_decode_table(v: torch.Tensor, remap: Optional[torch.Tensor] = None,
                       *, head_pack: int = 1,
                       scale: Optional[torch.Tensor] = None) -> DecodeStagedTable:
    """(B, N_rows, H, Dh) -> (B, H/G, N_rows, G·Dh), plus the int8 table's
    (B, 1, H, Dh) scale packed into the same per-group layout."""
    b, n_rows, h, dh = v.shape
    g = head_pack if (head_pack > 1 and h % head_pack == 0) else 1
    table_bytes = n_rows * g * dh * v.element_size()
    if remap is not None:
        table_bytes += remap.shape[-1] * 4
    sp = None
    if scale is not None:
        sp = scale.reshape(b, h // g, g * dh).to(torch.float32).contiguous()
        table_bytes += g * dh * 4
    return DecodeStagedTable(v=_stage_layout(v, g).contiguous(), remap=remap,
                             scale=sp, n_rows=n_rows, head_pack=g, dh=dh,
                             table_bytes=table_bytes)


def update_staged_rows(staged: DecodeStagedTable, row_idx: torch.Tensor,
                       rows: torch.Tensor) -> DecodeStagedTable:
    """Write re-projected rows (B, U, H, Dh) into the staged table at
    table rows ``row_idx`` (B, U), IN PLACE, with one ``index_put_``: the
    streaming path refreshes the changed tiles' slots of one persistent
    staged table instead of restaging it per frame, and K2 then samples
    ``staged.v`` at the address it always had. The rows are packed as
    the full staging packs them, so the result equals a fresh
    :func:`stage_decode_table` of the updated table bitwise; ``remap`` is
    untouched (a row update never changes the keep geometry). ``rows``
    must be in the staged dtype: an int8 table takes only int8 codes
    quantized against the frozen table scale."""
    if rows.dtype != staged.v.dtype:
        raise TypeError(
            f"update_staged_rows: rows dtype {rows.dtype} does not match "
            f"the staged table dtype {staged.v.dtype}; quantize rows "
            f"against the frozen table scale (int8 tables) or rebuild "
            f"the staging if the table dtype changed")
    b, u, h, dh = rows.shape
    g = staged.head_pack
    n_groups = staged.v.shape[1]
    packed = rows.reshape(b, u, n_groups, g * dh).permute(0, 2, 1, 3)
    dev = staged.v.device
    bidx = torch.arange(b, device=dev)[:, None, None]
    gidx = torch.arange(n_groups, device=dev)[None, :, None]
    staged.v.index_put_((bidx, gidx, row_idx.long()[:, None, :]), packed)
    return staged


def _corner_rows(x_px, y_px, start, wl, hl, remap):
    """The table row of every corner (B, L·Nq, H, K·4), through ``remap``
    when the table is compact, and the corner weights and validity
    (B, L, Nq, H, K, 4)."""
    from repro_torch.msda.sampling import corner_data
    b, n_layers, nq, h, k = x_px.shape
    idx, wgt, valid = corner_data(x_px, y_px, wl, hl, start)
    rows = idx.reshape(b, n_layers * nq, h, k * 4)
    if remap is not None:
        rows = torch.gather(remap, 1, rows.reshape(b, -1).long()).reshape(rows.shape)
    return rows, wgt, valid


def msgs_decode_plain(vp, x_px, y_px, start, wl, hl, probs, remap=None,
                      scale=None, *, head_pack: int, dh: int) -> torch.Tensor:
    """Plain PyTorch version over the staged layout: a mirror of the
    reference's ``msgs_decode_ref`` (repro/kernels/msgs_decode.py:294-318)
    — un-stage, dequantize up front, flat corner gather with bilinear
    weights. Points (B, L, Nq, H, K) -> (B, L, Nq, H, Dh)."""
    from repro_torch.msda.sampling import flat_gather_heads
    b = vp.shape[0]
    _, n_layers, nq, h, k = x_px.shape
    if scale is not None:
        vp = vp.to(probs.dtype) * scale[:, :, None, :].to(probs.dtype)
    rows, wgt, valid = _corner_rows(x_px, y_px, start, wl, hl, remap)
    eff_w = (wgt * valid.to(wgt.dtype) * probs[..., None]).reshape(rows.shape)
    g = flat_gather_heads(_unstage_layout(vp, head_pack, dh), rows)
    out = torch.sum(g * eff_w[..., None], dim=3)
    return out.reshape(b, n_layers, nq, h, dh).to(
        probs.dtype if scale is not None else out_dtype(vp.dtype))


def msgs_decode_backward_plain(vp, x_px, y_px, start, wl, hl, probs, g_out,
                               remap=None, scale=None, *, head_pack: int,
                               dh: int):
    """Closed-form vjp of :func:`msgs_decode_plain` — what the reference's
    ``_msgs_decode_bwd`` gets from ``jax.vjp`` of ``msgs_decode_ref``.

    With t1 = x - floor(x), t0 = y - floor(y), corner weights w_c (the
    products of ``corner_data``; floor has zero gradient) and v_c the
    (dequantized) row of valid corner c:

      d_table[row_c] += p w_c g          d_p = sum_c w_c <v_c, g>
      d_x = p sum_c dw_c/dt1 <v_c, g>    d_y = p sum_c dw_c/dt0 <v_c, g>

    Invalid corners contribute nothing; a pruned pixel's corner reaches
    the sentinel row through ``remap``, and that row gets its gradient.
    An int8 table's codes get none (None); its (B, H/G, G·Dh) scale gets
    d_scale = sum p w code g per channel. Returns (d_vp in ``vp``'s dtype
    or None, d_x, d_y, d_probs, d_scale or None)."""
    from repro_torch.msda.sampling import flat_gather_heads
    b, n_groups, n_rows, gdh = vp.shape
    _, n_layers, nq, h, k = x_px.shape
    acc = torch.promote_types(probs.dtype, torch.float32)
    v = vp.to(acc)
    if scale is not None:
        v = v * scale[:, :, None, :].to(acc)
    v4 = _unstage_layout(v, head_pack, dh)
    rows, wgt, valid = _corner_rows(x_px, y_px, start, wl, hl, remap)
    g = g_out.to(acc).reshape(b, n_layers * nq, h, 1, dh)
    dots = torch.sum(flat_gather_heads(v4, rows) * g, dim=-1)   # <v_c, g>
    vdots = valid.to(acc) * dots.reshape(wgt.shape)
    t1 = x_px - torch.floor(x_px)
    t0 = y_px - torch.floor(y_px)
    dw_dt1 = torch.stack([-(1 - t0), 1 - t0, -t0, t0], dim=-1)
    dw_dt0 = torch.stack([-(1 - t1), -t1, 1 - t1, t1], dim=-1)
    d_p = torch.sum(wgt * vdots, dim=-1)
    d_x = probs * torch.sum(dw_dt1 * vdots, dim=-1)
    d_y = probs * torch.sum(dw_dt0 * vdots, dim=-1)

    coef = (wgt * valid.to(acc) * probs[..., None]).reshape(rows.shape)
    bidx = torch.arange(b, device=vp.device).view(b, 1, 1, 1)
    hidx = torch.arange(h, device=vp.device).view(1, 1, h, 1)
    flat = ((bidx * n_rows + rows.long()) * h + hidx).reshape(-1)
    d_v4 = torch.zeros((b * n_rows * h, dh), dtype=acc, device=vp.device)
    d_v4.index_add_(0, flat, (coef[..., None] * g).reshape(-1, dh))
    d_v = _stage_layout(d_v4.reshape(b, n_rows, h, dh), head_pack)
    if scale is None:
        return d_v.to(vp.dtype), d_x, d_y, d_p, None
    d_scale = torch.sum(d_v * vp.to(acc), dim=2)
    return None, d_x, d_y, d_p, d_scale.to(scale.dtype)


#: argument types of the C entries. msgs_decode_forward: table code; 10
#: pointers (staged table, 6 point operands, remap, scale, out); B, L, Nq,
#: H, K, Dh, G; n_rows, n_pix; the table's gather plan; the stream.
#: msgs_decode_backward: table code; 16 pointers (the same 9 inputs,
#: g_out, d_vp, d_scale, d_x, d_y, d_probs, scratch); the same sizes; the
#: plans of the table's and g_out's rows; the stream.
#: msgs_decode_backward_scratch: table code, B, L, Nq, H, K, Dh, G;
#: n_rows; group_lanes, table_grad; the address of the byte count it
#: writes.
_SIZES = [ctypes.c_int] * 7 + [ctypes.c_int64] * 2
ARGTYPES = {
    "msgs_decode_forward": [ctypes.c_int] + [ctypes.c_void_p] * 10 + _SIZES
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "msgs_decode_backward": [ctypes.c_int] + [ctypes.c_void_p] * 16 + _SIZES
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "msgs_decode_backward_scratch": [ctypes.c_int] * 8 + [ctypes.c_int64]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


@functools.lru_cache(maxsize=None)
def _entry(library: str, name: str):
    """One C entry of a kernel library, every argument declared."""
    from repro_torch.kernels.build import load_library
    fn = getattr(load_library(library), name)
    fn.argtypes = ARGTYPES[name]
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


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def plan_args(plan: GatherPlan):
    """A gather plan as the C entries take it."""
    return plan.vec_bytes, plan.group_lanes, plan.lanes_per_row, plan.row_chunks


def table_plan(vp: torch.Tensor, n_items: int, head_pack: int,
               dh: int) -> GatherPlan:
    """The engine's plan for the staged table's rows, whose head h rows
    follow every ``head_pack * dh`` elements; ``n_items`` (layer, query,
    head) items per batch."""
    check_gather_sizes(n_items, head_pack * dh * vp.element_size(),
                       "msgs_decode")
    return gather_plan(dh, vp.element_size(), pointer_alignment(vp),
                       stride=head_pack * dh)


def _fake(vp, x_px, y_px, start, wl, hl, probs, remap, scale, head_pack, dh):
    b, n_layers, nq, h, _ = x_px.shape
    return vp.new_empty((b, n_layers, nq, h, dh), dtype=out_dtype(vp.dtype))


def _flops(vp, x_px, *_, out_shape=None, **__) -> int:
    return point_flops(x_px, out_shape[-1])


@kernel_op("msgs_decode", fake=_fake, flops=_flops)
def _launch(vp: torch.Tensor, x_px: torch.Tensor, y_px: torch.Tensor,
            start: torch.Tensor, wl: torch.Tensor, hl: torch.Tensor,
            probs: torch.Tensor, remap: Optional[torch.Tensor],
            scale: Optional[torch.Tensor], head_pack: int,
            dh: int) -> torch.Tensor:
    global LAUNCHES
    b, _, n_rows, _ = vp.shape
    _, n_layers, nq, h, k = x_px.shape
    out = torch.empty((b, n_layers, nq, h, dh), dtype=out_dtype(vp.dtype),
                      device=vp.device)
    n_pix = 0 if remap is None else remap.shape[1]
    plan = table_plan(vp, n_layers * nq * h, head_pack, dh)
    with torch.cuda.device(vp.device):
        code = _entry("msgs_decode", "msgs_decode_forward")(
            TABLE_CODES[vp.dtype], ptr(vp), ptr(x_px), ptr(y_px), ptr(start),
            ptr(wl), ptr(hl), ptr(probs), ptr(remap), ptr(scale), ptr(out),
            b, n_layers, nq, h, k, dh, head_pack, n_rows, n_pix,
            *plan_args(plan), stream_ptr(vp.device))
    LAUNCHES += 1
    raise_on_error(code, "msgs_decode")
    return out


def _fake_backward(vp, x_px, y_px, start, wl, hl, probs, g_out, remap, scale,
                   head_pack, dh, table_grad):
    dev = vp.device
    d_v = torch.empty_like(vp) if table_grad and scale is None \
        else no_tensor(dev)
    d_s = no_tensor(dev) if scale is None else torch.empty_like(scale)
    return (d_v, torch.empty_like(x_px), torch.empty_like(y_px),
            torch.empty_like(probs), d_s)


def _flops_backward(vp, x_px, y_px, start, wl, hl, probs, g_out, *_,
                    out_shape=None, **__) -> int:
    """Every corner of every point valid and live: ``<v_c, g>`` and the
    scatter of ``p w_c g`` for each of the 4 corners."""
    return g_out[-1] * 4 * numel(x_px) * (FLOPS_PER_CHANNEL_CORNER_DOT
                                          + FLOPS_PER_CHANNEL_CORNER_SCATTER)


@kernel_op("msgs_decode_backward", fake=_fake_backward, flops=_flops_backward)
def _launch_backward(vp: torch.Tensor, x_px: torch.Tensor, y_px: torch.Tensor,
                     start: torch.Tensor, wl: torch.Tensor, hl: torch.Tensor,
                     probs: torch.Tensor, g_out: torch.Tensor,
                     remap: Optional[torch.Tensor],
                     scale: Optional[torch.Tensor], head_pack: int, dh: int,
                     table_grad: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Every output and the scratch are ``torch.empty``, sized from the
    shapes alone: the kernels write each element once, and nothing waits
    for the host. ``g_out`` is float32 and contiguous; an output not
    computed (d_v without ``table_grad`` or of int8 codes, d_s of a float
    table) is an empty placeholder."""
    global LAUNCHES_BWD
    b, _, n_rows, _ = vp.shape
    _, n_layers, nq, h, k = x_px.shape
    dev = vp.device
    d_x, d_y, d_p = (torch.empty_like(t) for t in (x_px, y_px, probs))
    plan = table_plan(vp, n_layers * nq * h, head_pack, dh)
    table_grad = table_grad and scale is None
    d_v = torch.empty(vp.shape, dtype=vp.dtype, device=dev) if table_grad else None
    d_s = None if scale is None else torch.empty_like(scale)
    sizes = (b, n_layers, nq, h, k, dh, head_pack, n_rows)
    nbytes = ctypes.c_int64(0)
    code = _entry("msgs_decode_bwd", "msgs_decode_backward_scratch")(
        TABLE_CODES[vp.dtype], *sizes, plan.group_lanes,
        int(table_grad), ctypes.addressof(nbytes))
    raise_on_error(code, "msgs_decode_backward_scratch")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev) \
        if nbytes.value else None
    n_pix = 0 if remap is None else remap.shape[1]
    g_plan = gather_plan(dh, 4, pointer_alignment(g_out))
    with torch.cuda.device(dev):
        code = _entry("msgs_decode_bwd", "msgs_decode_backward")(
            TABLE_CODES[vp.dtype], ptr(vp), ptr(x_px), ptr(y_px), ptr(start),
            ptr(wl), ptr(hl), ptr(probs), ptr(remap), ptr(scale), ptr(g_out),
            ptr(d_v), ptr(d_s), ptr(d_x), ptr(d_y), ptr(d_p), ptr(scratch),
            *sizes, n_pix, *plan_args(plan), *plan_args(g_plan),
            stream_ptr(dev))
    LAUNCHES_BWD += 1
    raise_on_error(code, "msgs_decode_backward")
    return (no_tensor(dev) if d_v is None else d_v, d_x, d_y, d_p,
            no_tensor(dev) if d_s is None else d_s)


def msgs_decode_backward(staged: DecodeStagedTable, x_px, y_px, start, wl, hl,
                         probs, g_out):
    """The vjp of :func:`msgs_decode_layers` for output gradient ``g_out
    (B, L, Nq, H, Dh)``: (d staged table or None, d_x, d_y, d_probs,
    d_scale or None). A float table gets its gradient in its own dtype;
    int8 codes get none, their scale does. CUDA tensors launch the
    backward kernel; CPU tensors run :func:`msgs_decode_backward_plain`."""
    pts = (x_px, y_px, start, wl, hl, probs)
    _check(staged, pts)
    want = x_px.shape[:4] + (staged.dh,)
    if tuple(g_out.shape) != tuple(want) or g_out.device != x_px.device:
        raise ValueError(f"msgs_decode_backward: g_out must be {tuple(want)} "
                         f"on {x_px.device}, got {tuple(g_out.shape)} on "
                         f"{g_out.device}")
    return _backward(staged.v, *pts, g_out, staged.remap, staged.scale,
                     staged.head_pack, staged.dh, table_grad=True)


def _backward(vp, x_px, y_px, start, wl, hl, probs, g_out, remap, scale,
              head_pack, dh, table_grad):
    """``table_grad`` False (the staged table needs no gradient) skips the
    table gradient, and on the card its corner keys and table kernel."""
    if not on_card(vp):
        d_v, *rest = msgs_decode_backward_plain(
            vp, x_px, y_px, start, wl, hl, probs, g_out, remap, scale,
            head_pack=head_pack, dh=dh)
        return (d_v if table_grad else None, *rest)
    d_v, d_x, d_y, d_p, d_s = _launch_backward(
        vp, x_px, y_px, start, wl, hl, probs,
        g_out.to(torch.float32).contiguous(), remap, scale, head_pack, dh,
        table_grad)
    return (d_v if d_v.numel() else None, d_x, d_y, d_p,
            None if scale is None else d_s)


class MsgsDecode(torch.autograd.Function):
    """K2 as an autograd op, the port of the reference's ``custom_vjp``
    ``_msgs_decode`` (repro/kernels/msgs_decode.py:335-379).

    ``apply(vp, x_px, y_px, start, wl, hl, probs, remap, scale, head_pack,
    dh)``: forward samples the staged table, backward returns gradients
    for the staged float table (none for int8 codes), x, y, probs and the
    int8 scale, and None for the integer geometry and ``remap``. CUDA
    tensors run the two kernels, CPU tensors the two plain versions."""

    @staticmethod
    def forward(ctx, vp, x_px, y_px, start, wl, hl, probs, remap, scale,
                head_pack, dh):
        pts = (x_px, y_px, start, wl, hl, probs)
        if not on_card(vp):
            out = msgs_decode_plain(vp, *pts, remap, scale,
                                    head_pack=head_pack, dh=dh)
        else:
            out = _launch(vp, *pts, remap, scale, head_pack, dh)
        ctx.save_for_backward(vp, *pts, remap, scale)
        ctx.head_pack, ctx.dh = head_pack, dh
        return out

    @staticmethod
    def backward(ctx, g_out):
        vp, x_px, y_px, start, wl, hl, probs, remap, scale = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_v, d_x, d_y, d_p, d_s = _backward(
            vp, x_px, y_px, start, wl, hl, probs, g_out, remap, scale,
            ctx.head_pack, ctx.dh, table_grad=need[0])
        keep = lambda t, i: t if need[i] else None
        return (keep(d_v, 0), keep(d_x, 1), keep(d_y, 2), None, None, None,
                keep(d_p, 6), None, None if d_s is None else keep(d_s, 8),
                None, None)


def msgs_decode_layers(staged: DecodeStagedTable, x_px, y_px, start, wl, hl,
                       probs) -> torch.Tensor:
    """Stacked multi-layer decode: ONE launch samples the staged table for
    all layers' points ``(B, L, Nq, H, K)``. Returns (B, L, Nq, H, Dh);
    differentiable (:class:`MsgsDecode`)."""
    pts = (x_px, y_px, start, wl, hl, probs)
    _check(staged, pts)
    return MsgsDecode.apply(staged.v, *pts, staged.remap, staged.scale,
                            staged.head_pack, staged.dh)


def msgs_decode(staged: DecodeStagedTable, x_px, y_px, start, wl, hl,
                probs) -> torch.Tensor:
    """Per-layer decode launch (the decoder path: layer l's coordinates
    exist only after layer l-1). Points (B, Nq, H, K) -> (B, Nq, H, Dh)."""
    add_l = lambda a: a[:, None]
    return msgs_decode_layers(staged, add_l(x_px), add_l(y_px), add_l(start),
                              add_l(wl), add_l(hl), add_l(probs))[:, 0]
