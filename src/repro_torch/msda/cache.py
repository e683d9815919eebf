"""MSDAValueCache — build-once, sample-everywhere value tables (port of
repro/msda/cache.py; the streaming row updates wait for that slice).

The cache is the projected, head-laid-out, optionally FWP-compacted value
table plus what a backend needs to sample it: ``pix2slot`` (pixel ->
compact slot, None when dense), ``keep_idx`` (raster-ordered slot ->
pixel), the int8 ``scale`` when the table holds codes, and — when the
plan's backend is ``cuda_decode`` — the table staged once in the decode
launch layout. Every encoder block builds its own cache; the decoder
builds one from the encoder memory and every layer samples it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import fwp as fwp_lib
from repro_torch.core.quant import (maybe_fake_quant, quantize_table_rows,
                                    table_quant_scale)


class MSDAValueCache(NamedTuple):
    """Projected (optionally FWP-compacted) value table + sampling geometry."""
    v: torch.Tensor                     # (B, N_rows, H, Dh) table
    pix2slot: Optional[torch.Tensor]    # (B, N_in) pixel -> slot (or None)
    keep_idx: Optional[torch.Tensor]    # (B, cap) slot -> pixel, raster-ordered
    n_rows: int                         # row count of ``v``
    table_bytes: int                    # bytes per (batch, head-group) of
    #   this table under the reference's lane layout (+ indirection)
    staged: Optional[object] = None     # DecodeStagedTable for cuda_decode
    scale: Optional[torch.Tensor] = None  # (B, 1, H, Dh) f32 when ``v``
    #   holds int8 codes; every sampler multiplies once after aggregation


def _project(x: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    w = maybe_fake_quant(params["value_w"], cfg.weight_bits)
    return torch.einsum("bnd,dhk->bnhk", x, w) + params["value_b"]


def project_values(params: dict, cfg, x_flat: torch.Tensor,
                   fwp_state: Optional[fwp_lib.FWPState]):
    """FWP-pruned value projection V = X W^V.

    Returns (v (B, N_rows, H, Dh), pix2slot or None, n_rows)."""
    b, n_in, d = x_flat.shape
    h, dh = cfg.n_heads, cfg.head_dim
    if fwp_state is not None and cfg.fwp_mode == "compact":
        cap = fwp_state.keep_idx.shape[1]
        gidx = fwp_state.keep_idx.long()[..., None].expand(-1, -1, d)
        v = _project(torch.gather(x_flat, 1, gidx), params, cfg)
        v = torch.cat([v, torch.zeros((b, 1, h, dh), dtype=v.dtype,
                                      device=v.device)], dim=1)
        pix2slot = fwp_state.pix2slot
        n_rows = cap + 1
    elif fwp_state is not None and cfg.fwp_mode == "mask":
        keep = fwp_state.keep_mask.to(x_flat.dtype)
        v = _project(x_flat * keep[..., None], params, cfg)
        v = v * keep[..., None, None].to(v.dtype)   # bias must not leak
        pix2slot = None
        n_rows = n_in
    else:
        v = _project(x_flat, params, cfg)
        pix2slot = None
        n_rows = n_in
    return maybe_fake_quant(v, cfg.act_bits), pix2slot, n_rows


def build_value_cache(params: dict, plan, x_flat: torch.Tensor,
                      state=None) -> MSDAValueCache:
    """Build the shared value cache for one memory ``x_flat``.

    ``params`` needs only ``value_w``/``value_b``; ``state``'s FWP link
    decides the compaction (None / no link => dense table).

    Every call bumps ``msda_cache_build_traces_total`` on the process-wide
    registry, as the reference's trace-time bump does
    (repro/msda/cache.py:111-119). This body runs on the host: under
    CUDA-graph capture it runs once, while the graph is recorded, and a
    replay never runs it, so the counter stays flat under replay."""
    from repro_torch.obs.metrics import default_registry
    default_registry().counter(
        "msda_cache_build_traces_total",
        "build_value_cache tracings/eager builds (process-wide)"
    ).inc(backend=plan.backend, table_dtype=plan.table_dtype)
    cfg = plan.cfg
    fwp_state = getattr(state, "fwp", None)
    v, pix2slot, n_rows = project_values(params, cfg, x_flat, fwp_state)
    keep_idx = fwp_state.keep_idx if pix2slot is not None else None

    scale = None
    if plan.quantized_table:
        # int8 codes + per-channel scale; the sentinel row is code 0
        scale = table_quant_scale(v)
        v = quantize_table_rows(v, scale)

    table_bytes = plan.table_bytes_for_rows(
        n_rows, with_indirection=pix2slot is not None)
    staged = None
    if plan.backend == "cuda_decode":
        from repro_torch.kernels import msgs_decode
        staged = msgs_decode.stage_decode_table(
            v, pix2slot, head_pack=plan.decode_head_pack, scale=scale)
    return MSDAValueCache(v=v, pix2slot=pix2slot, keep_idx=keep_idx,
                          n_rows=n_rows, table_bytes=table_bytes,
                          staged=staged, scale=scale)
