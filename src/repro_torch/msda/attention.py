"""Planned MSDA execution (port of repro/msda/attention.py).

  * :func:`msda_attention_cached` — the plan's query ordering, PAP'd
    probabilities, point generation, backend-dispatched MSGS +
    aggregation and (optionally) the FWP frequency count, all against a
    prebuilt value cache;
  * :func:`msda_attention` — build a fresh cache from ``x_flat`` and
    sample it (encoder blocks, whose memory changes every block).

Both are ``collectives.run_local`` of their rank body steps
(:func:`msda_attention_cached_body`, :func:`msda_attention_body`): under
``act_sharding.batch_split`` (a DETR cell's rank holding its images of
the batch) the per-tensor INT12 scales of the value table, the
probabilities and the offsets are the whole batch's, one max over the
data axes each, as the reference's partitioner takes them.

FWP needs no such max. Its tier score ``freq + keep * (max freq + 1)``
(``core.fwp.build_fwp_state``) picks the same rows whether the max is
the rank's or the batch's: the counts are integers, exact in float32,
and any offset above a row's own max puts every kept pixel above every
pruned one and leaves the order among the kept, so the per-row top-k is
the same. The thresholds are per-row means.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import fwp as fwp_lib
from repro_torch.core.quant import maybe_fake_quant
from repro_torch.distributed.collectives import run_local
from repro_torch.msda import backends as backend_registry
from repro_torch.msda import ordering as ordering_lib
from repro_torch.msda.cache import MSDAValueCache, build_value_cache_body
from repro_torch.msda.pipeline import MSDAPipelineState
from repro_torch.msda.plan import MSDAPlan
from repro_torch.msda.sampling import corner_data, generate_points_body


def msda_attention_cached(
    params: dict,
    plan: MSDAPlan,
    query: torch.Tensor,                # (B, Nq, D)
    ref_points: torch.Tensor,           # (B, Nq, 2) normalized
    cache: MSDAValueCache,
    state: Optional[MSDAPipelineState] = None,
    *,
    collect_stats: bool = False,
    update_fwp: bool = True,
) -> Tuple[torch.Tensor, MSDAPipelineState]:
    """One planned MSDA sampling pass against a prebuilt value cache.

    ``update_fwp=False`` (decoder layers) skips the frequency count and
    carries the existing FWP link through. Returns (out (B, Nq, D), next
    state).

    With a ``query_order`` the queries are sorted by reference point
    before sampling and the output is put back in the caller's order;
    every per-query op is row-independent, so the result equals the
    unordered pass bitwise. Raster-only backends (``cuda_windowed``)
    derive their tile windows from raster query position and stay
    unpermuted. A decoder layer derives its permutation from its own
    incoming reference points."""
    return run_local(msda_attention_cached_body(
        params, plan, query, ref_points, cache, state,
        collect_stats=collect_stats, update_fwp=update_fwp))


def msda_attention_cached_body(
    params: dict,
    plan: MSDAPlan,
    query: torch.Tensor,
    ref_points: torch.Tensor,
    cache: MSDAValueCache,
    state: Optional[MSDAPipelineState] = None,
    *,
    collect_stats: bool = False,
    update_fwp: bool = True,
):
    """Rank body step of :func:`msda_attention_cached`."""
    cfg = plan.cfg
    b = query.shape[0]
    if state is None:
        state = MSDAPipelineState.initial()

    inv_perm = None
    if plan.query_order != "none" \
            and not backend_registry.backend_info(plan.backend).raster_only:
        perm, inv_perm = ordering_lib.query_permutation(
            ref_points, plan.level_shapes, plan.query_order)
        query = ordering_lib.permute_queries(query, perm)
        ref_points = ordering_lib.permute_queries(ref_points, perm)

    sel, pts = yield from generate_points_body(
        params, cfg, query, ref_points, plan.level_shapes,
        pix2slot=cache.pix2slot, keep_idx=cache.keep_idx)
    backend = backend_registry.get_backend(plan.backend)
    out_h = backend(plan, cache.v, pts, sel.probs, cache=cache)

    out_w = maybe_fake_quant(params["out_w"], cfg.weight_bits)
    dt = torch.promote_types(out_h.dtype, out_w.dtype)
    out = torch.einsum("bnhk,hkd->bnd", out_h.to(dt), out_w.to(dt)) \
        + params["out_b"]
    if inv_perm is not None:
        out = ordering_lib.invert_queries(out, inv_perm)

    # ---- FWP frequency counting for the NEXT block ------------------------
    need_freq = update_fwp and cfg.fwp_mode != "off"
    next_fwp = None if update_fwp else state.fwp
    stats = None
    if need_freq or collect_stats:
        pt_alive = (sel.probs > 0).to(torch.float32)   # pruned pts don't count
        # counted in ORIGINAL pixel space (pre-compaction)
        idx_orig, _, valid_orig = corner_data(pts.x_px, pts.y_px,
                                              pts.wl, pts.hl, pts.start)
        counted = valid_orig.to(torch.float32) * pt_alive[..., None]
        freq = fwp_lib.count_frequency(idx_orig.reshape(b, -1),
                                       counted.reshape(b, -1), plan.n_in)
        if need_freq:
            next_fwp = fwp_lib.build_fwp_state(
                freq, plan.level_shapes, k=cfg.fwp_k, mode=cfg.fwp_mode,
                capacity=cfg.fwp_capacity)
        if collect_stats:
            stats = {
                "freq": freq,
                "pap_keep_frac": sel.keep_frac,
                "point_alive_frac": pt_alive.mean(),
                "value_rows": cache.n_rows,
                "cache_table_bytes": cache.table_bytes,
            }
            if update_fwp and next_fwp is not None:
                stats["fwp_keep_frac"] = 1.0 - fwp_lib.fwp_sparsity(next_fwp)
    return out, state.advance(next_fwp, stats)


def msda_attention(
    params: dict,
    plan: MSDAPlan,
    query: torch.Tensor,                # (B, Nq, D)
    ref_points: torch.Tensor,           # (B, Nq, 2) normalized
    x_flat: torch.Tensor,               # (B, N_in, D) raw fmap features
    state: Optional[MSDAPipelineState] = None,
    *,
    collect_stats: bool = False,
) -> Tuple[torch.Tensor, MSDAPipelineState]:
    """One planned MSDA block: build the value cache, then sample it."""
    return run_local(msda_attention_body(params, plan, query, ref_points,
                                         x_flat, state,
                                         collect_stats=collect_stats))


def msda_attention_body(
    params: dict,
    plan: MSDAPlan,
    query: torch.Tensor,
    ref_points: torch.Tensor,
    x_flat: torch.Tensor,
    state: Optional[MSDAPipelineState] = None,
    *,
    collect_stats: bool = False,
):
    """Rank body step of :func:`msda_attention`."""
    if x_flat.shape[1] != plan.n_in:
        raise ValueError(f"x_flat has {x_flat.shape[1]} pixels, the plan "
                         f"{plan.n_in}")
    if state is None:
        state = MSDAPipelineState.initial()
    cache = yield from build_value_cache_body(params, plan, x_flat, state)
    return (yield from msda_attention_cached_body(
        params, plan, query, ref_points, cache, state,
        collect_stats=collect_stats))
