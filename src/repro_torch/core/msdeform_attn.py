"""Multi-Scale Deformable Attention: config, init and the per-level oracle
(port of repro/core/msdeform_attn.py).

Conventions (official Deformable-DETR): reference points normalized to
[0,1]² and shared across levels; sampling_location_l = ref + ΔP_l /
(W_l, H_l) with offsets in pixel units; grid-sample semantics
align_corners=False with zero padding: pixel-space x = loc_x · W_l − 0.5.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import host_constant
from repro_torch.core import fwp as fwp_lib
from repro_torch.core import nn


@dataclasses.dataclass(frozen=True)
class MSDeformAttnConfig:
    d_model: int = 256
    n_heads: int = 8
    n_levels: int = 4
    n_points: int = 4
    # --- DEFA algorithm knobs ---------------------------------------------
    pap_mode: str = "off"                # off | threshold | topk
    pap_threshold: float = 0.02
    pap_keep: int = 4                    # topk mode: points kept of n_levels*n_points
    fwp_mode: str = "off"                # off | mask | compact
    fwp_k: float = 1.0                   # Eq. 2 hyper-parameter
    fwp_capacity: float = 0.6            # compact mode keep fraction
    range_narrow: Optional[Tuple[float, ...]] = None   # per-level |offset| bound (px)
    act_bits: Optional[int] = None       # 12 => INT12 fake-quant (paper default)
    weight_bits: Optional[int] = None
    impl: str = "jnp"                    # legacy: jnp | pallas (see `backend`)
    backend: Optional[str] = None        # msda backend name or "auto"
    dtype: torch.dtype = torch.float32
    table_dtype: Optional[str] = None    # value-table storage dtype; None
    #   resolves via REPRO_MSDA_TABLE_DTYPE, falling back to `dtype`
    query_order: Optional[str] = None    # none | raster | zorder; None
    #   resolves via REPRO_MSDA_QUERY_ORDER, falling back to "none"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def n_lp(self) -> int:
        return self.n_levels * self.n_points


def offset_ring_bias(cfg: MSDeformAttnConfig) -> np.ndarray:
    """Deformable-DETR grid init of the offset bias: points start on a
    ring around the reference, scaled by point index. (H, L*P*2)."""
    h = cfg.n_heads
    thetas = np.arange(h) * (2.0 * np.pi / h)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)          # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, cfg.n_levels, cfg.n_points, 1))
    grid = grid * (np.arange(cfg.n_points) + 1.0)[None, None, :, None]
    return grid.reshape(h, cfg.n_lp * 2).astype(np.float32)


def init_msdeform_attn(cfg: MSDeformAttnConfig, gen: torch.Generator,
                       device="cpu") -> dict:
    """Same shapes and init rules as the reference: normal(0, 1/sqrt(d))
    projections, zero offset weights, the ring grid offset bias."""
    d, h, lp, dh = cfg.d_model, cfg.n_heads, cfg.n_lp, cfg.head_dim
    scale = 1.0 / math.sqrt(d)
    t = dict(dtype=cfg.dtype, device=device)
    return {
        "attn_w": (torch.randn((d, h, lp), generator=gen) * scale).to(**t),
        "attn_b": torch.zeros((h, lp), **t),
        "offs_w": torch.zeros((d, h, lp * 2), **t),
        "offs_b": torch.as_tensor(offset_ring_bias(cfg)).to(**t),
        "value_w": (torch.randn((d, h, dh), generator=gen) * scale).to(**t),
        "value_b": torch.zeros((h, dh), **t),
        "out_w": (torch.randn((h, dh, d), generator=gen) * scale).to(**t),
        "out_b": torch.zeros((d,), **t),
    }


# --------------------------------------------------------------------------
# Reference oracle — independent per-level implementation (no flat tricks)
# --------------------------------------------------------------------------

def _bilinear_sample_level(v: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """v: (B, Hl, Wl, nH, Dh); loc: (B, Nq, nH, P, 2) normalized [0,1].

    Returns (B, Nq, nH, P, Dh). align_corners=False, zero padding."""
    b, hl, wl, nh, dh = v.shape
    x = loc[..., 0] * wl - 0.5
    y = loc[..., 1] * hl - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    t1 = x - x0
    t0 = y - y0
    vv = v.reshape(b, hl * wl, nh, dh).permute(0, 2, 1, 3).reshape(
        b * nh, hl * wl, dh)

    def gather(ix, iy):
        valid = (ix >= 0) & (ix < wl) & (iy >= 0) & (iy < hl)
        ixc = torch.clamp(ix, 0, wl - 1).long()
        iyc = torch.clamp(iy, 0, hl - 1).long()
        flat = iyc * wl + ixc                                     # (B,Nq,nH,P)
        ii = flat.permute(0, 2, 1, 3).reshape(b * nh, -1)
        g = torch.gather(vv, 1, ii[..., None].expand(-1, -1, dh))
        g = g.reshape(b, nh, flat.shape[1], flat.shape[3], dh).permute(
            0, 2, 1, 3, 4)
        return g * valid[..., None]

    n00 = gather(x0, y0)
    n10 = gather(x0 + 1, y0)
    n01 = gather(x0, y0 + 1)
    n11 = gather(x0 + 1, y0 + 1)
    w00 = ((1 - t1) * (1 - t0))[..., None]
    w10 = (t1 * (1 - t0))[..., None]
    w01 = ((1 - t1) * t0)[..., None]
    w11 = (t1 * t0)[..., None]
    return n00 * w00 + n10 * w10 + n01 * w01 + n11 * w11


@host_constant
def _level_norm(wl: int, hl: int, dtype, device) -> torch.Tensor:
    """(W_l, H_l) of one level, built once per (level, dtype, device)."""
    return torch.as_tensor([wl, hl], dtype=dtype, device=device)


def msdeform_attn_ref(params: dict, cfg: MSDeformAttnConfig,
                      query: torch.Tensor, ref_points: torch.Tensor,
                      x_flat: torch.Tensor,
                      level_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Pure per-level oracle, no pruning/quant/kernel. (B,Nq,D) out."""
    from repro_torch.core.quant import fake_table_quant
    from repro_torch.msda.plan import resolve_table_dtype
    b, nq, _ = query.shape
    h, l, p = cfg.n_heads, cfg.n_levels, cfg.n_points
    logits = torch.einsum("bnd,dhk->bnhk", query, params["attn_w"]) \
        + params["attn_b"]
    probs = torch.softmax(logits, dim=-1)                          # (B,Nq,H,LP)
    offs = torch.einsum("bnd,dhk->bnhk", query, params["offs_w"]) \
        + params["offs_b"]
    offs = offs.reshape(b, nq, h, l, p, 2)
    if cfg.range_narrow is not None:
        from repro_torch.msda.sampling import level_bounds
        bounds = level_bounds(cfg.range_narrow, query.dtype,
                              query.device).reshape(1, 1, 1, l, 1, 1)
        offs = nn.clip(offs, -bounds, bounds)
    v = torch.einsum("bnd,dhk->bnhk", x_flat, params["value_w"]) \
        + params["value_b"]
    if resolve_table_dtype(cfg) == "int8":
        # sample the same quantized values the int8 backends store
        v = fake_table_quant(v)

    starts, _ = fwp_lib.level_starts(level_shapes)
    out = torch.zeros((b, nq, h, cfg.head_dim), dtype=query.dtype,
                      device=query.device)
    probs_l = probs.reshape(b, nq, h, l, p)
    for li, (hl, wl) in enumerate(level_shapes):
        s = int(starts[li])
        v_l = v[:, s:s + hl * wl].reshape(b, hl, wl, h, cfg.head_dim)
        norm = _level_norm(int(wl), int(hl), query.dtype, query.device)
        loc = ref_points[:, :, None, None, :] + offs[:, :, :, li] / norm
        sampled = _bilinear_sample_level(v_l, loc)                 # (B,Nq,H,P,Dh)
        out = out + torch.sum(sampled * probs_l[:, :, :, li, :, None], dim=3)
    return torch.einsum("bnhk,hkd->bnd", out, params["out_w"]) + params["out_b"]


# --------------------------------------------------------------------------
# DEFA dataflow: the reference's compatibility entry point over repro_torch.msda
# --------------------------------------------------------------------------

def msdeform_attn_apply(
    params: dict,
    cfg: MSDeformAttnConfig,
    query: torch.Tensor,                # (B, Nq, D)
    ref_points: torch.Tensor,           # (B, Nq, 2) normalized
    x_flat: torch.Tensor,               # (B, N_in, D) raw fmap features
    level_shapes: Sequence[Tuple[int, int]],
    fwp_state: Optional[fwp_lib.FWPState] = None,
    *,
    collect_stats: bool = False,
):
    """DEFA-optimized MSDeformAttn (port of the reference's shim,
    repro/core/msdeform_attn.py:198). Resolves a memoized plan through
    ``plan_for`` (legacy ``cfg.impl`` maps to a backend name, ``"auto"``
    to the planner's pick) and returns (out (B, Nq, D), aux): aux holds
    ``fwp_state`` (the link for the NEXT block) when FWP is on, and the
    block's stats (``pap_keep_frac``, ``fwp_keep_frac``, ...) when
    ``collect_stats``. New code should use :mod:`repro_torch.msda`."""
    from repro_torch.msda import MSDAPipelineState, msda_attention, plan_for

    plan = plan_for(cfg, tuple((int(h), int(w)) for h, w in level_shapes),
                    n_queries=int(query.shape[1]), device=x_flat.device)
    state = MSDAPipelineState(fwp=fwp_state)
    out, state = msda_attention(params, plan, query, ref_points, x_flat,
                                state=state, collect_stats=collect_stats)
    aux: dict = {}
    if cfg.fwp_mode != "off":
        aux["fwp_state"] = state.fwp
    if collect_stats and state.block_stats:
        aux.update(state.block_stats[-1])
    return out, aux
