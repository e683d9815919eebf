"""Distributed MSDeformAttn: band sharding with a bounded halo exchange
(port of ``repro/core/distributed_msdeform.py``).

The paper's level-wise range narrowing bounds every sampling offset to
±R_l pixels, so distributing the encoder needs a two-neighbour halo
exchange, not an all-gather of the multi-scale feature map:

  * every model-axis rank owns one horizontal BAND of the image — the same
    normalized y-interval of every pyramid level (queries AND value rows);
  * the value projection V = X·W^V runs band-locally (1/TP of the pixels);
  * each rank sends its top/bottom halo_l = ceil(R_l)+2 value rows to its
    neighbours — range narrowing guarantees every bilinear corner of a
    band's queries lands inside band ± halo; a level whose band is
    thinner than its halo is all-gathered instead;
  * sampling + aggregation are then fully rank-local.

Per-layer communication: 2·Σ_l halo_l·W_l·D per image (independent of
image height) versus Σ_l H_l·W_l·D for an all-gather of the pyramid.

The reference's ``shard_map`` body is :func:`banded_body`, a rank body
of ``distributed.collectives``; :func:`msdeform_attn_banded` runs it on
every rank of an ``InProcessMesh`` (global tensors in and out) or on
this process's rank of a ``DeviceMesh`` (the rank's tensors in and out).
As in the reference, the INT12 fake-quant scales inside the body
(values, probabilities, offsets) are the band's own amax, not the
image's. Sampling is the plain gather the reference runs here
(``take_along_axis``); no kernel is on this path."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quant import maybe_fake_quant
from repro_torch.distributed import collectives as C
from repro_torch.msda.sampling import corner_data, select_points


def band_layout(level_shapes, n_bands: int, ranges):
    """Per-level padded band geometry: (rows_per_band_l, halo_l)."""
    rows, halos = [], []
    for li, (h, w) in enumerate(level_shapes):
        rows.append(int(math.ceil(h / n_bands)))
        halos.append(int(math.ceil(ranges[li])) + 2)
    return rows, halos


def pad_levels_to_bands(x_flat: torch.Tensor, level_shapes, n_bands: int):
    """Pad each level's rows to n_bands*rows_per_band and re-flatten.

    x_flat: (B, N_in, D) -> (B, N_pad, D), plus padded level shapes."""
    b, _, d = x_flat.shape
    rows, _ = band_layout(level_shapes, n_bands, [0] * len(level_shapes))
    pieces, padded_shapes = [], []
    start = 0
    for (h, w), rb in zip(level_shapes, rows):
        seg = x_flat[:, start:start + h * w].reshape(b, h, w, d)
        hp = rb * n_bands
        seg = torch.nn.functional.pad(seg, (0, 0, 0, 0, 0, hp - h))
        pieces.append(seg.reshape(b, hp * w, d))
        padded_shapes.append((hp, w))
        start += h * w
    return torch.cat(pieces, dim=1), tuple(padded_shapes)


def _band_slices(padded_shapes, n_bands):
    """Flat index ranges of ONE band across levels (band-local layout)."""
    locs = []
    start = 0
    for (hp, w) in padded_shapes:
        rb = hp // n_bands
        locs.append((start, rb, w))
        start += rb * w
    return locs, start                 # per-level (band start, rows, W), band size


def halo_levels(padded_shapes, n_bands: int, ranges):
    """Per level: True where the band exchanges halos, False where its
    band is thinner than its halo and the level is all-gathered."""
    return [int(math.ceil(r)) + 2 < hp // n_bands
            for (hp, _), r in zip(padded_shapes, ranges)]


def band_comm_pixels(padded_shapes, n_bands: int, ranges) -> int:
    """Value rows (pixels) one rank sends per image per block: the
    reference's 2·Σ_l halo_l·W_l over halo levels, plus its band of
    every all-gathered level."""
    total = 0
    for (hp, w), r, ex in zip(padded_shapes, ranges,
                              halo_levels(padded_shapes, n_bands, ranges)):
        total += 2 * (int(math.ceil(r)) + 2) * w if ex else (hp // n_bands) * w
    return total


def banded_body(ctx: C.RankContext, prm: dict, cfg, q_b: torch.Tensor,
                ref_b: torch.Tensor, x_b: torch.Tensor,
                padded_shapes: Sequence[Tuple[int, int]], axis: str = "model"):
    """One rank's band: (B, N_band, D) queries, (B, N_band, 2) reference
    points and (B, N_band, D) pixels in band-local level-major order;
    returns the band's (B, N_band, D) output."""
    n_bands = ctx.size[axis]
    rank = ctx.index[axis]
    h, dh = cfg.n_heads, cfg.head_dim
    locs, _ = _band_slices(padded_shapes, n_bands)
    b, nq_b, d = q_b.shape
    wq = lambda w_: maybe_fake_quant(w_, cfg.weight_bits)

    # --- band-local value projection (1/TP of the pixels) -----------------
    v = torch.einsum("bnd,dhk->bnhk", x_b, wq(prm["value_w"])) + prm["value_b"]
    v = maybe_fake_quant(v, cfg.act_bits)

    # --- halo exchange per level (2-neighbour ring) ------------------------
    v_locals = []                 # (window (B,rows,W,H,Dh), gathered?)
    for li, ((hp, w_l), (st, rb, _)) in enumerate(zip(padded_shapes, locs)):
        hal = int(math.ceil(cfg.range_narrow[li])) + 2
        seg = v[:, st:st + rb * w_l].reshape(b, rb, w_l, h, dh)
        if hal >= rb:
            # band thinner than the sampling radius: a 1-hop halo can't
            # cover it — replicate this (small) level via all-gather
            vfull = yield C.all_gather(axis, seg, dim=1)
            v_locals.append((vfull, True))
            continue
        top, bot = seg[:, :hal], seg[:, -hal:]
        # halo ABOVE band j = band j-1's BOTTOM rows (bottoms sent down);
        # halo BELOW band j = band j+1's TOP rows (tops sent up).
        from_above, from_below = yield C.ring_exchange(axis, bot, top)
        # first/last band: zero halo beyond the image (the wrap is masked
        # out by the validity check, but zero it for exactness)
        if rank == 0:
            from_above = torch.zeros_like(from_above)
        if rank == n_bands - 1:
            from_below = torch.zeros_like(from_below)
        v_locals.append((torch.cat([from_above, seg, from_below], dim=1), False))

    # --- sampling-point generation (PAP-aware, shared with msda) ----------
    sel, offs_k, lvl_of_pt = select_points(prm, cfg, q_b)

    # --- per-level local gather + Eq.4 BI + aggregation --------------------
    out_h = torch.zeros((b, nq_b, h, dh), dtype=q_b.dtype, device=q_b.device)
    for li, ((hp, w_l), (st, rb, _)) in enumerate(zip(padded_shapes, locs)):
        hal = int(math.ceil(cfg.range_narrow[li])) + 2
        window, gathered = v_locals[li]
        vloc = window.reshape(b, -1, h, dh)              # rows*(W) flat
        n_rows_loc = window.shape[1]
        on_lvl = (lvl_of_pt == li)
        x_px = ref_b[:, :, None, None, 0] * float(w_l) + offs_k[..., 0] - 0.5
        y_px = ref_b[:, :, None, None, 1] * float(hp) + offs_k[..., 1] - 0.5
        # band-local row coordinates (halo offset added); gathered levels
        # use global coordinates directly
        y_loc = y_px if gathered else y_px - rank * rb + hal
        ones = torch.ones_like(lvl_of_pt)
        idx, wgt, valid = corner_data(x_px, y_loc, ones * w_l,
                                      ones * n_rows_loc, torch.zeros_like(ones))
        # validity in GLOBAL image coords, as a stacked mask over the four
        # corners (the reference's form)
        yg = torch.floor(y_px)
        extra = torch.stack([((yg + dy) >= 0) & ((yg + dy) < hp)
                             for dy in (0, 0, 1, 1)], dim=-1)
        valid = valid & extra
        eff_w = wgt * valid.to(wgt.dtype) \
            * (sel.probs * on_lvl.to(wgt.dtype))[..., None]
        k_pts = idx.shape[3]
        vv = vloc.permute(0, 2, 1, 3).reshape(b * h, -1, dh)
        ii = idx.permute(0, 2, 1, 3, 4).reshape(b * h, -1).long()
        g = torch.gather(vv, 1, ii[..., None].expand(-1, -1, dh))
        g = g.reshape(b, h, nq_b, k_pts, 4, dh).permute(0, 2, 1, 3, 4, 5)
        out_h = out_h + torch.sum(g * eff_w[..., None], dim=(3, 4)).to(out_h.dtype)

    return torch.einsum("bnhk,hkd->bnd", out_h, wq(prm["out_w"])) + prm["out_b"]


def _specs(batch_axes):
    bspec = (tuple(batch_axes) if len(batch_axes) != 1 else batch_axes[0]) \
        if batch_axes else None
    return bspec


def msdeform_attn_banded(params: dict, cfg, query: torch.Tensor,
                         ref_points: torch.Tensor, x_flat: torch.Tensor,
                         padded_shapes: Sequence[Tuple[int, int]], mesh,
                         axis: str = "model",
                         batch_axes: Tuple[str, ...] = (),
                         stats: C.CommStats | None = None):
    """Band-sharded MSDeformAttn. Requires cfg.range_narrow set (the bound
    IS what makes the halo finite).

    The flat layout here is BAND-MAJOR: for band r, its rows of level 0,
    then its rows of level 1, ... (callers reorder with band_reorder).

    On an ``InProcessMesh``: query, ref_points and x_flat are the global
    (B, N_pad, ·) tensors; every rank runs in turn and the global
    (B, N_pad, D) output returns. On a ``DeviceMesh``: they are this
    rank's (B / batch shards, N_pad / bands, ·) tensors, or DTensors laid
    out ``P(batch_axes, axis, None)``, and the rank's output returns (a
    DTensor for DTensor inputs)."""
    if cfg.range_narrow is None:
        raise ValueError("halo exchange needs range-narrowing")
    spec = (_specs(batch_axes), axis, None)
    if isinstance(mesh, C.InProcessMesh):
        sizes = C.mesh_shape(mesh)

        def make(rank, ctx):
            sl = lambda t: t[C.local_slices(spec, t.shape, sizes, ctx.index)]
            return banded_body(ctx, params, cfg, sl(query), sl(ref_points),
                               sl(x_flat), padded_shapes, axis)

        outs = C.run_in_process(make, mesh, stats)
        shape = tuple(query.shape[:2]) + (outs[0].shape[-1],)
        return C.assemble(dict(enumerate(outs)), spec, shape, mesh)
    from torch.distributed.tensor import DTensor
    as_dtensor = isinstance(query, DTensor)
    loc = lambda t: t.to_local() if isinstance(t, DTensor) else t
    out = C.run_spmd(banded_body(C.rank_context(mesh), params, cfg, loc(query),
                                 loc(ref_points), loc(x_flat), padded_shapes,
                                 axis), mesh, stats)
    if as_dtensor:
        return DTensor.from_local(out, mesh, query.placements)
    return out


def band_reorder(flat_padded: torch.Tensor, padded_shapes, n_bands: int):
    """Level-major padded layout -> band-major layout (and inverse perm)."""
    perm = []
    starts = np.concatenate(
        [[0], np.cumsum([hp * w for hp, w in padded_shapes])[:-1]])
    for r in range(n_bands):
        for (hp, w), st in zip(padded_shapes, starts):
            rb = hp // n_bands
            base = st + r * rb * w
            perm.extend(range(base, base + rb * w))
    perm = np.asarray(perm)
    inv = np.argsort(perm)
    idx = torch.as_tensor(perm, device=flat_padded.device)
    return flat_padded[:, idx], perm, inv
