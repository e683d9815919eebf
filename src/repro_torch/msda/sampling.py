"""Shared sampling-point machinery for every MSDA backend (port of
repro/msda/sampling.py).

One place computes, for each (batch, query, head, point), the
PAP-surviving probabilities, the range-narrowed fake-quantized offsets,
and the per-point level geometry (flat start, width, height) with the
absolute pixel coordinates in the point's own level. Backends differ
only in how they gather and bilinearly combine the value rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import host_constant
from repro_torch.core import fwp as fwp_lib
from repro_torch.core import nn
from repro_torch.core import pap as pap_lib
from repro_torch.core.quant import maybe_fake_quant, maybe_fake_quant_body
from repro_torch.distributed.collectives import run_local


class SamplingPoints(NamedTuple):
    """Backend-agnostic sampling geometry. All point arrays (B, Nq, H, K)."""
    x_px: torch.Tensor        # absolute pixel x in the point's own level
    y_px: torch.Tensor
    start: torch.Tensor       # int32 flat start of the point's level
    wl: torch.Tensor          # int32 level width per point
    hl: torch.Tensor          # int32 level height per point
    lvl_of_pt: torch.Tensor   # int32 level index per point
    pix2slot: Optional[torch.Tensor]   # (B, N_pix) FWP-compact indirection
    keep_idx: Optional[torch.Tensor] = None   # (B, cap) slot -> pixel map


def level_meta(level_shapes: Sequence[Tuple[int, int]], device="cpu"):
    """Per-level int32 tensors: flat starts, widths, heights; total N_in.
    Built once per (level_shapes, device); callers only read them."""
    return _level_meta(tuple((int(h), int(w)) for h, w in level_shapes),
                       torch.device(device))


@host_constant
def _level_meta(level_shapes, device: torch.device):
    starts, n_in = fwp_lib.level_starts(level_shapes)
    ws = np.asarray([w for _, w in level_shapes], np.int32)
    hs = np.asarray([h for h, _ in level_shapes], np.int32)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return as_t(starts), as_t(ws), as_t(hs), n_in


def corner_data(x_px, y_px, wl, hl, start):
    """Per-point corner indices/weights/validity in the flat fmap.

    Returns idx (..., 4) int32, wgt (..., 4), valid (..., 4) bool; corner
    order (0,0), (1,0), (0,1), (1,1) as (dx, dy)."""
    x0 = torch.floor(x_px)
    y0 = torch.floor(y_px)
    t1 = x_px - x0
    t0 = y_px - y0
    wmax = (wl - 1).to(x_px.dtype)
    hmax = (hl - 1).to(x_px.dtype)
    idxs, wgts, valids = [], [], []
    for dy in (0, 1):
        for dx in (0, 1):
            cx = x0 + dx
            cy = y0 + dy
            valids.append((cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl))
            cxc = torch.minimum(torch.clamp(cx, min=0), wmax).to(torch.int32)
            cyc = torch.minimum(torch.clamp(cy, min=0), hmax).to(torch.int32)
            idxs.append(start + cyc * wl + cxc)
            wgts.append((t1 if dx else (1 - t1)) * (t0 if dy else (1 - t0)))
    return (torch.stack(idxs, dim=-1), torch.stack(wgts, dim=-1),
            torch.stack(valids, dim=-1))


def flat_gather_heads(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v: (B, N, H, Dh); idx: (B, Nq, H, M) -> (B, Nq, H, M, Dh)."""
    b, n, h, dh = v.shape
    _, nq, _, m = idx.shape
    vv = v.permute(0, 2, 1, 3).reshape(b * h, n, dh)
    ii = idx.permute(0, 2, 1, 3).reshape(b * h, nq * m).long()
    g = torch.gather(vv, 1, ii[..., None].expand(-1, -1, dh))
    return g.reshape(b, h, nq, m, dh).permute(0, 2, 1, 3, 4)


def level_bounds(range_narrow, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The per-level offset bound ``range_narrow`` as an (L,) tensor,
    built once per (bounds, dtype, device)."""
    return _level_bounds(tuple(float(r) for r in range_narrow), dtype,
                         torch.device(device))


@host_constant
def _level_bounds(range_narrow, dtype, device) -> torch.Tensor:
    return torch.as_tensor(range_narrow, dtype=dtype, device=device)


def select_points(params: dict, cfg, query: torch.Tensor):
    """PAP selection + masked offset generation (pre-geometry).

    Returns (sel: PAPSelection, offs_k (B,Nq,H,K,2) range-narrowed and
    quantized, lvl_of_pt (B,Nq,H,K) int32)."""
    return run_local(select_points_body(params, cfg, query))


def select_points_body(params: dict, cfg, query: torch.Tensor):
    """Rank body step of :func:`select_points`: the INT12 scales of the
    probabilities and the offsets are the whole batch's under a batch
    split (``core.quant.maybe_fake_quant_body``)."""
    b, nq, _ = query.shape
    h, p, lp = cfg.n_heads, cfg.n_points, cfg.n_lp
    wq = lambda w: maybe_fake_quant(w, cfg.weight_bits)

    logits = torch.einsum("bnd,dhk->bnhk",
                          *nn.promoted(query, wq(params["attn_w"]))) \
        + params["attn_b"]
    probs = torch.softmax(logits, dim=-1)
    probs = yield from maybe_fake_quant_body(probs, cfg.act_bits)
    sel = pap_lib.pap_select(probs, cfg.pap_mode,
                             threshold=cfg.pap_threshold, k=cfg.pap_keep)

    offs = torch.einsum("bnd,dhk->bnhk",
                        *nn.promoted(query, wq(params["offs_w"]))) \
        + params["offs_b"]
    offs = offs.reshape(b, nq, h, lp, 2)
    pidx = sel.point_idx.long()
    offs_k = torch.gather(offs, 3, pidx[..., None].expand(-1, -1, -1, -1, 2))
    lvl_of_pt = torch.div(pidx, p, rounding_mode="floor")
    if cfg.range_narrow is not None:
        bounds = level_bounds(cfg.range_narrow, query.dtype,
                              query.device)[lvl_of_pt][..., None]
        offs_k = nn.clip(offs_k, -bounds, bounds)      # jnp.clip's gradient
    offs_k = yield from maybe_fake_quant_body(offs_k, cfg.act_bits)  # INT12 BI input
    return sel, offs_k, lvl_of_pt.to(torch.int32)


def generate_points(params: dict, cfg, query: torch.Tensor,
                    ref_points: torch.Tensor,
                    level_shapes: Sequence[Tuple[int, int]],
                    pix2slot: Optional[torch.Tensor] = None,
                    keep_idx: Optional[torch.Tensor] = None):
    """Full point generation: PAP + offsets + flat-level geometry.

    Returns (sel: PAPSelection, pts: SamplingPoints)."""
    return run_local(generate_points_body(params, cfg, query, ref_points,
                                          level_shapes, pix2slot, keep_idx))


def generate_points_body(params: dict, cfg, query: torch.Tensor,
                         ref_points: torch.Tensor,
                         level_shapes: Sequence[Tuple[int, int]],
                         pix2slot: Optional[torch.Tensor] = None,
                         keep_idx: Optional[torch.Tensor] = None):
    """Rank body step of :func:`generate_points`
    (:func:`select_points_body`)."""
    starts, ws, hs, _ = level_meta(level_shapes, device=query.device)
    sel, offs_k, lvl_of_pt = yield from select_points_body(params, cfg, query)
    lvl = lvl_of_pt.long()
    wl, hl, st = ws[lvl], hs[lvl], starts[lvl]
    x_px = ref_points[:, :, None, None, 0] * wl.to(query.dtype) \
        + offs_k[..., 0] - 0.5
    y_px = ref_points[:, :, None, None, 1] * hl.to(query.dtype) \
        + offs_k[..., 1] - 0.5
    pts = SamplingPoints(x_px=x_px, y_px=y_px, start=st, wl=wl, hl=hl,
                         lvl_of_pt=lvl_of_pt, pix2slot=pix2slot,
                         keep_idx=keep_idx)
    return sel, pts
