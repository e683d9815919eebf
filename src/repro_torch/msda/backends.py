"""Named MSDA execution backends (port of repro/msda/backends.py).

Every backend implements one contract::

    backend(plan, v (B, N_rows, H, Dh), pts: SamplingPoints,
            probs (B, Nq, H, K), cache=None) -> (B, Nq, H, Dh)

Names map to the reference's backends:

  ==============  ==================  ====================================
  port            reference           what runs
  ==============  ==================  ====================================
  ``torch_gather``  ``jnp_gather``      plain PyTorch flat gather (any device)
  ``cuda_fused``    ``pallas_fused``    kernel K1, ``csrc/msgs_fused.cu``
  ``cuda_windowed`` ``pallas_windowed`` kernel K3, ``csrc/msgs_windowed.cu``:
                                        raster encoder queries only, each
                                        query tile samples the
                                        range-narrowed window of every level
  ``cuda_decode``   ``pallas_decode``   kernel K2, ``csrc/msgs_decode.cu``,
                                        on the once-staged decode table
  ==============  ==================  ====================================

The CUDA backends launch their kernel for tensors on the card and take
the kernel's plain PyTorch version only for tensors on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from repro_torch.msda.sampling import SamplingPoints, corner_data, flat_gather_heads

BackendFn = Callable[..., torch.Tensor]


class BackendInfo(NamedTuple):
    """``raster_only`` backends need Nq == N_in; ``decode_only`` backends
    need a decode-shaped plan (N_q learned queries)."""
    raster_only: bool = False
    decode_only: bool = False


_REGISTRY: Dict[str, BackendFn] = {}
_INFO: Dict[str, BackendInfo] = {}


def register_backend(name: str, *, raster_only: bool = False,
                     decode_only: bool = False):
    def deco(fn: BackendFn) -> BackendFn:
        _REGISTRY[name] = fn
        _INFO[name] = BackendInfo(raster_only=raster_only,
                                  decode_only=decode_only)
        return fn
    return deco


def get_backend(name: str) -> BackendFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no MSDA backend {name!r}; "
                       f"available: {available_backends()}") from None


def backend_info(name: str) -> BackendInfo:
    return _INFO.get(name, BackendInfo())


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def candidate_backends(*, decode_shaped: bool) -> List[str]:
    """Registered backends eligible for one query geometry (the
    autotuner's candidate set): decode-shaped launches exclude
    ``raster_only`` backends, raster launches exclude ``decode_only``
    ones."""
    return [name for name in available_backends()
            if not (_INFO[name].raster_only if decode_shaped
                    else _INFO[name].decode_only)]


@register_backend("torch_gather")
def torch_gather(plan, v: torch.Tensor, pts: SamplingPoints,
                 probs: torch.Tensor, cache=None) -> torch.Tensor:
    """Mirror of ``jnp_gather``: flat corner gather + weighted sum."""
    b, nq, h, k = probs.shape
    idx, wgt, valid = corner_data(pts.x_px, pts.y_px, pts.wl, pts.hl, pts.start)
    idx = idx.reshape(b, nq, h, k * 4)
    if pts.pix2slot is not None:
        idx = torch.gather(pts.pix2slot, 1, idx.reshape(b, -1).long()
                           ).reshape(idx.shape)              # pruned -> sentinel
    eff_w = wgt * valid.to(wgt.dtype) * probs[..., None]
    g = flat_gather_heads(v, idx)
    scale = getattr(cache, "scale", None)
    if scale is not None:
        g = g.to(probs.dtype)          # aggregate codes, dequantize once
    out = torch.sum(g * eff_w.reshape(b, nq, h, k * 4)[..., None], dim=3)
    if scale is not None:
        out = out * scale.to(out.dtype)
    return out


def _point_operands(pts: SamplingPoints, probs: torch.Tensor):
    return tuple(t.contiguous() for t in
                 (pts.x_px, pts.y_px, pts.start, pts.wl, pts.hl, probs))


@register_backend("cuda_fused")
def cuda_fused(plan, v: torch.Tensor, pts: SamplingPoints,
               probs: torch.Tensor, cache=None) -> torch.Tensor:
    """Kernel K1 over the (maybe FWP-compacted) table; one kernel serves
    the reference's plain and head-packed entry points."""
    from repro_torch.kernels import msgs_fused
    return msgs_fused.msgs_fused(v.contiguous(), *_point_operands(pts, probs),
                                 remap=pts.pix2slot,
                                 scale=getattr(cache, "scale", None))


def _require_raster(plan, nq: int) -> None:
    if nq != plan.n_in:
        raise ValueError(f"windowed backends need raster-ordered encoder "
                         f"queries (Nq={nq} != N_in={plan.n_in}); plan a "
                         "different backend")
    if plan.cfg.range_narrow is None:
        raise ValueError("windowed backends need cfg.range_narrow")


@register_backend("cuda_windowed", raster_only=True)
def cuda_windowed(plan, v: torch.Tensor, pts: SamplingPoints,
                  probs: torch.Tensor, cache=None) -> torch.Tensor:
    """Kernel K3, one launch across all levels; under FWP compact it
    samples the compacted table through ``pix2slot`` with slot windows
    located by ``keep_idx``. Mirrors ``pallas_windowed``
    (repro/msda/backends.py:173-218)."""
    from repro_torch.core import fwp as fwp_lib
    from repro_torch.kernels import msgs_windowed
    cfg = plan.cfg
    b, nq, h, _ = probs.shape
    _require_raster(plan, nq)
    g = plan.head_pack if (plan.lane_layout == "pack"
                           and h % plan.head_pack == 0) else 1
    caps = None
    if pts.pix2slot is not None:
        if pts.keep_idx is None:
            raise ValueError("FWP-compact windowed sampling needs the "
                             "raster-ordered keep_idx (slot -> pixel map)")
        caps = fwp_lib.level_capacities(plan.level_shapes, cfg.fwp_capacity)
    scale = getattr(cache, "scale", None)
    if scale is not None:
        # per head group, as the kernel's (batch, group) blocks read it
        scale = scale.reshape(b, h // g, g, v.shape[3])
    return msgs_windowed.msgs_windowed_msp(
        v.contiguous(), *(t.contiguous() for t in
                          (pts.x_px, pts.y_px, pts.lvl_of_pt, probs)),
        remap=pts.pix2slot, keep_idx=pts.keep_idx, scale=scale,
        level_shapes=plan.level_shapes, ranges=cfg.range_narrow,
        tile_q=plan.tile_q, head_pack=g, caps=caps)


@register_backend("cuda_decode", decode_only=True)
def cuda_decode(plan, v: torch.Tensor, pts: SamplingPoints,
                probs: torch.Tensor, cache=None) -> torch.Tensor:
    """Kernel K2 against the table staged once per memory by
    ``build_value_cache``; a caller without a prebuilt cache pays one
    staging per call."""
    from repro_torch.kernels import msgs_decode
    staged = getattr(cache, "staged", None)
    if staged is None:
        staged = msgs_decode.stage_decode_table(
            v, pts.pix2slot, head_pack=plan.decode_head_pack,
            scale=getattr(cache, "scale", None))
    return msgs_decode.msgs_decode(staged, *_point_operands(pts, probs))
