"""MSDAValueCache — build-once, sample-everywhere value tables (port of
repro/msda/cache.py).

The cache is the projected, head-laid-out, optionally FWP-compacted value
table plus what a backend needs to sample it: ``pix2slot`` (pixel ->
compact slot, None when dense), ``keep_idx`` (raster-ordered slot ->
pixel), the int8 ``scale`` when the table holds codes, and — when the
plan's backend is ``cuda_decode`` — the table staged once in the decode
launch layout. Every encoder block builds its own cache; the decoder
builds one from the encoder memory and every layer samples it.

Streaming video keeps one cache alive across frames and refreshes only
the rows whose pixels changed: :func:`update_value_cache_rows`
re-projects a row subset (:func:`project_cache_rows`, against the frozen
activation scale of the last full build, :func:`cache_act_scale`) and
writes it IN PLACE into the table (:func:`scatter_table_rows`) and its
decode staging (``kernels/msgs_decode.update_staged_rows``), so the
tables keep their addresses from frame to frame.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import fwp as fwp_lib
from repro_torch.core import nn
from repro_torch.core.quant import (maybe_fake_quant, maybe_fake_quant_body,
                                    maybe_fake_quant_with_scale, quant_scale,
                                    quantize_table_rows, table_quant_scale)
from repro_torch.distributed.collectives import run_local


class MSDAValueCache(NamedTuple):
    """Projected (optionally FWP-compacted) value table + sampling geometry."""
    v: torch.Tensor                     # (B, N_rows, H, Dh) table
    pix2slot: Optional[torch.Tensor]    # (B, N_in) pixel -> slot (or None)
    keep_idx: Optional[torch.Tensor]    # (B, cap) slot -> pixel, raster-ordered
    n_rows: int                         # row count of ``v``
    slot_windows: Tuple[int, ...]       # per-level slot-window extents
    #   (compact mode, the zero sentinel excluded; () when dense)
    table_bytes: int                    # bytes per (batch, head-group) of
    #   this table under the reference's lane layout (+ indirection)
    staged: Optional[object] = None     # DecodeStagedTable for cuda_decode
    scale: Optional[torch.Tensor] = None  # (B, 1, H, Dh) f32 when ``v``
    #   holds int8 codes; every sampler multiplies once after aggregation


def _project(x: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    w = maybe_fake_quant(params["value_w"], cfg.weight_bits)
    return torch.einsum("bnd,dhk->bnhk", *nn.promoted(x, w)) \
        + params["value_b"]


def project_values(params: dict, cfg, x_flat: torch.Tensor,
                   fwp_state: Optional[fwp_lib.FWPState]):
    """FWP-pruned value projection V = X W^V.

    Returns (v (B, N_rows, H, Dh), pix2slot or None, n_rows)."""
    return run_local(project_values_body(params, cfg, x_flat, fwp_state))


def project_values_body(params: dict, cfg, x_flat: torch.Tensor,
                        fwp_state: Optional[fwp_lib.FWPState]):
    """Rank body step of :func:`project_values`: the INT12 scale of the
    table is the whole batch's under a batch split (``core.quant.
    maybe_fake_quant_body``)."""
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
    v = yield from maybe_fake_quant_body(v, cfg.act_bits)
    return v, pix2slot, n_rows


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
    return run_local(build_value_cache_body(params, plan, x_flat, state))


def build_value_cache_body(params: dict, plan, x_flat: torch.Tensor,
                           state=None):
    """Rank body step of :func:`build_value_cache`
    (:func:`project_values_body`)."""
    from repro_torch.obs.metrics import default_registry
    default_registry().counter(
        "msda_cache_build_traces_total",
        "build_value_cache tracings/eager builds (process-wide)"
    ).inc(backend=plan.backend, table_dtype=plan.table_dtype)
    cfg = plan.cfg
    fwp_state = getattr(state, "fwp", None)
    v, pix2slot, n_rows = yield from project_values_body(params, cfg, x_flat,
                                                         fwp_state)
    keep_idx = fwp_state.keep_idx if pix2slot is not None else None

    scale = None
    if plan.quantized_table:
        # int8 codes + per-channel scale; the sentinel row is code 0
        scale = table_quant_scale(v)
        v = quantize_table_rows(v, scale)

    table_bytes = plan.table_bytes_for_rows(
        n_rows, with_indirection=pix2slot is not None)
    slot_windows: Tuple[int, ...] = ()
    if pix2slot is not None:
        caps = fwp_lib.level_capacities(plan.level_shapes, cfg.fwp_capacity)
        slot_windows = tuple(min(int(c), n_rows - 1) for c in caps)
    staged = None
    if plan.backend == "cuda_decode":
        from repro_torch.kernels import msgs_decode
        staged = msgs_decode.stage_decode_table(
            v, pix2slot, head_pack=plan.decode_head_pack, scale=scale)
    return MSDAValueCache(v=v, pix2slot=pix2slot, keep_idx=keep_idx,
                          n_rows=n_rows, slot_windows=slot_windows,
                          table_bytes=table_bytes, staged=staged, scale=scale)


# --------------------------------------------------------------------------
# Incremental (streaming) row updates
# --------------------------------------------------------------------------

def cache_act_scale(cache: MSDAValueCache, cfg) -> Optional[torch.Tensor]:
    """The frozen per-tensor activation-quant scale of a built cache
    (None without ``act_bits``): the largest |value| sits on the grid's
    endpoint, so ``quant_scale`` of the built table reproduces the scale
    the build used. An int8 table is read through its per-channel scale
    (the per-channel amax survives quantization exactly)."""
    if cfg.act_bits is None or cfg.act_bits <= 0:
        return None
    v = cache.v
    if cache.scale is not None:
        v = v.to(cache.scale.dtype) * cache.scale
    return quant_scale(v, cfg.act_bits)


def project_cache_rows(params: dict, cfg, x_flat: torch.Tensor,
                       pix_idx: torch.Tensor,
                       keep_mask: Optional[torch.Tensor] = None,
                       act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Value-project the pixel rows ``pix_idx`` (B, U) of one memory, as
    the matching rows of a full :func:`project_values` build: the same
    weight fake-quant and bias, mask-mode zeroing through ``keep_mask``,
    and activation fake-quant against the FROZEN ``act_scale``. Returns
    (B, U, H, Dh)."""
    d = x_flat.shape[2]
    x_rows = torch.gather(x_flat, 1, pix_idx.long()[..., None].expand(-1, -1, d))
    if keep_mask is not None:                        # fwp_mode == "mask"
        m_rows = torch.gather(keep_mask, 1, pix_idx.long())
        x_rows = x_rows * m_rows[..., None].to(x_rows.dtype)
    rows = _project(x_rows, params, cfg)
    if keep_mask is not None:
        rows = rows * m_rows[..., None, None].to(rows.dtype)
    return maybe_fake_quant_with_scale(rows, cfg.act_bits, act_scale)


def scatter_table_rows(v: torch.Tensor, slot_idx: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Write (B, U, H, Dh) rows into the (B, N_rows, H, Dh) table at rows
    ``slot_idx`` (B, U), in place; returns ``v``. The dtypes must match:
    an int8 table takes int8 codes (quantized against the cache's frozen
    scale), never float rows."""
    if rows.dtype != v.dtype:
        raise TypeError(
            f"scatter_table_rows: rows dtype {rows.dtype} != table dtype "
            f"{v.dtype}; quantize rows against the cache's frozen scale "
            f"before scattering into an int8 table")
    b = v.shape[0]
    bidx = torch.arange(b, device=v.device)[:, None]
    v[bidx, slot_idx.long()] = rows
    return v


def update_value_cache_rows(params: dict, plan, cache: MSDAValueCache,
                            x_flat: torch.Tensor, slot_idx: torch.Tensor,
                            act_scale: Optional[torch.Tensor] = None,
                            keep_mask: Optional[torch.Tensor] = None,
                            ) -> Tuple[MSDAValueCache, int]:
    """Re-project the table rows ``slot_idx`` (B, U) from the new memory
    ``x_flat`` and write them in place into ``cache.v`` and, when the
    plan staged the decode layout, into ``cache.staged`` (through
    ``update_staged_rows``). The keep geometry is untouched: a row update
    changes which values the slots hold, never which pixels hold slots.
    Returns ``(cache, staged_bytes_delta)``, the delta being U rows under
    the plan's lane layout with no pix2slot restage."""
    if cache.keep_idx is not None:                   # compact: slot -> pixel
        pix_idx = torch.gather(cache.keep_idx, 1, slot_idx.long())
    else:                                            # dense/mask: slot == pixel
        pix_idx = slot_idx
    rows = project_cache_rows(params, plan.cfg, x_flat, pix_idx,
                              keep_mask=keep_mask, act_scale=act_scale)
    if cache.scale is not None:
        # int8 end to end: the refreshed rows are quantized against the
        # cache's FROZEN per-channel scale
        rows = quantize_table_rows(rows, cache.scale)
    scatter_table_rows(cache.v, slot_idx, rows)
    if cache.staged is not None:
        from repro_torch.kernels import msgs_decode
        msgs_decode.update_staged_rows(cache.staged, slot_idx, rows)
    return cache, plan.table_bytes_for_rows(slot_idx.shape[1],
                                            with_indirection=False)
