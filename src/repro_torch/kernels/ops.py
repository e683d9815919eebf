"""The kernels under the reference's public names (port of
``repro/kernels/ops.py``).

Each name goes to the port's wrapper of the same kernel: the tensors'
device decides, so there is no ``interpret`` argument — CUDA tensors
launch the hand-written kernel, CPU tensors run its plain PyTorch
version. Integer point operands are cast to int32 here, as the
reference casts them before its kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import msgs_decode as _msgs_decode
from repro_torch.kernels import msgs_fused as _msgs_fused
from repro_torch.kernels import msgs_windowed as _msgs_windowed


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def msgs_fused(v, x_px, y_px, start, wl, hl, probs,
               remap: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None):
    """Fused grid-sample + aggregation (K1). ``scale`` is the int8
    table's (B, 1, H, Dh) dequant scale."""
    return _msgs_fused.msgs_fused(v, x_px, y_px, _i32(start), _i32(wl),
                                  _i32(hl), probs, remap=remap, scale=scale)


def msgs_fused_packed(v, x_px, y_px, start, wl, hl, probs,
                      remap: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None, *,
                      head_pack: int = 4):
    """The head-packed entry point of K1 (the same kernel on the card)."""
    return _msgs_fused.msgs_fused_packed(v, x_px, y_px, _i32(start), _i32(wl),
                                         _i32(hl), probs, remap=remap,
                                         scale=scale, head_pack=head_pack)


def msgs_windowed_msp(v, x_px, y_px, lvl_of_pt, probs,
                      remap: Optional[torch.Tensor] = None,
                      keep_idx: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None, *,
                      level_shapes, ranges, tile_q: int = 128,
                      head_pack: int = 1, caps=None):
    """Single-launch multi-scale-parallel windowed MSGS (K3)."""
    return _msgs_windowed.msgs_windowed_msp(
        v, x_px, y_px, _i32(lvl_of_pt), probs, remap, keep_idx, scale,
        level_shapes=level_shapes, ranges=ranges, tile_q=tile_q,
        head_pack=head_pack, caps=caps)


def stage_decode_table(v, remap=None, *, head_pack: int = 1, scale=None):
    """Stage the value table once in the decode launch layout (K2)."""
    return _msgs_decode.stage_decode_table(v, remap, head_pack=head_pack,
                                           scale=scale)


def msgs_decode(staged, x_px, y_px, start, wl, hl, probs):
    """Per-layer persistent decode sampling against a staged table (K2,
    differentiable: its backward is a kernel too)."""
    return _msgs_decode.msgs_decode(staged, x_px, y_px, start, wl, hl, probs)


def msgs_decode_layers(staged, x_px, y_px, start, wl, hl, probs):
    """Stacked multi-layer persistent decode: one launch for all layers."""
    return _msgs_decode.msgs_decode_layers(staged, x_px, y_px, start, wl, hl,
                                           probs)


def matmul(x, w, w_scale=None, *, bm: int = 128, bn: int = 128, bk: int = 128):
    """Tiled matmul (K4); the int8-weight variant dequantizes in-kernel."""
    return _matmul.matmul(x, w, w_scale, bm=bm, bn=bn, bk=bk)


def flash_decode(q, k, v, valid, *, chunk: int = 512, kv_heads=None,
                 partial: bool = False):
    """Fused one-token GQA decode attention over a masked KV cache (K5);
    ``kv_heads`` names the stored KV head each query head reads; with
    ``partial``, the float32 output and its log-sum-exp, for a merge of
    ranks that each hold a slice of the slots."""
    return _flash_decode.flash_decode(q, k, v, valid, chunk=chunk,
                                      kv_heads=kv_heads, partial=partial)
