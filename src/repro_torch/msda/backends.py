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
  ``cuda_decode``   ``pallas_decode``   kernel K2, ``csrc/msgs_decode.cu``,
                                        on the once-staged decode table
  ==============  ==================  ====================================

``cuda_fused`` and ``cuda_decode`` launch their CUDA kernel for tensors on
the card and take the kernel's plain PyTorch version only for tensors on
the CPU. ``pallas_windowed`` has no port yet (ROADMAP, kernel K3).
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
