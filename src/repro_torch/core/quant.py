"""Fake-quantization for the DEFA INT12 path (port of repro/core/quant.py).

Symmetric uniform quantization:  q = clip(round(x / s), -2^(b-1), 2^(b-1)-1),
s = max|x| / (2^(b-1) - 1), per-tensor or per-channel. ``torch.round``
rounds half to even, as ``jnp.round`` does. The straight-through
estimator is ``x + (y - x).detach()``.

:func:`maybe_fake_quant_body` is the per-tensor fake-quant as a rank
body step: where a rank holds its rows of a batch split over the data
axes (``act_sharding.batch_split``), its max is the whole batch's, as
the reference's partitioner takes ``max|x|`` over the whole array.
"""
from __future__ import annotations

from typing import Optional

import torch


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quant_scale(x: torch.Tensor, bits: int,
                axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric scale; per-tensor (axis=None) or per-channel along `axis`."""
    amax = x.abs().max() if axis is None \
        else x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp(amax, min=1e-8) / qmax(bits)


def quantize(x: torch.Tensor, bits: int, axis: Optional[int] = None):
    """Returns (int32 codes, scale)."""
    s = quant_scale(x, bits, axis)
    q = torch.clamp(torch.round(x / s), -qmax(bits) - 1, qmax(bits)).to(torch.int32)
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * s.to(dtype)


def fake_quant_with_scale(x: torch.Tensor, bits: int,
                          scale: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize against a given scale, straight-through."""
    y = torch.clamp(torch.round(x / scale), -qmax(bits) - 1, qmax(bits)) * scale
    return x + (y - x).detach()


def maybe_fake_quant_with_scale(x: torch.Tensor, bits: Optional[int],
                                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Fake-quant against a FROZEN scale (streaming row updates share the
    grid of the last full build); identity without bits or scale."""
    if bits is None or bits <= 0 or scale is None:
        return x
    return fake_quant_with_scale(x, bits, scale)


def fake_quant(x: torch.Tensor, bits: int = 12,
               axis: Optional[int] = None) -> torch.Tensor:
    """quantize -> dequantize on the tensor's own scale, straight-through."""
    return fake_quant_with_scale(x, bits, quant_scale(x, bits, axis))


def maybe_fake_quant(x: torch.Tensor, bits: Optional[int],
                     axis: Optional[int] = None) -> torch.Tensor:
    if bits is None or bits <= 0:
        return x
    return fake_quant(x, bits, axis)


def maybe_fake_quant_body(x: torch.Tensor, bits: Optional[int]):
    """Rank body step: :func:`maybe_fake_quant` per tensor, its max over
    the batch axes of a batch split (``act_sharding.batch_max``); off a
    split the same bits as :func:`maybe_fake_quant`."""
    if bits is None or bits <= 0:
        return x
    from repro_torch.distributed.act_sharding import batch_max
    amax = yield from batch_max(x.abs().max())
    return fake_quant_with_scale(x, bits,
                                 torch.clamp(amax, min=1e-8) / qmax(bits))


def table_quant_scale(v: torch.Tensor) -> torch.Tensor:
    """Per-channel int8 scale of a (B, N_rows, H, Dh) value table, shared
    across the rows axis: shape (B, 1, H, Dh), float32. A backend may
    aggregate int8 codes and multiply by the scale once afterwards."""
    return quant_scale(v, 8, axis=1).to(torch.float32)


def quantize_table_rows(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize (B, U, H, Dh) table rows onto a (B, 1, H, Dh) grid."""
    return torch.clamp(torch.round(rows / scale), -128, 127).to(torch.int8)


def fake_table_quant(v: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize a value table on the int8 table grid."""
    s = table_quant_scale(v)
    return quantize_table_rows(v, s).to(v.dtype) * s.to(v.dtype)


def pack_int8(x: torch.Tensor):
    """Real int8 storage (the bandwidth variant): per-channel over the
    last dim; returns (int8 codes, float32 scale)."""
    s = quant_scale(x, 8, axis=-1)
    q = torch.clamp(torch.round(x / s), -128, 127).to(torch.int8)
    return q, s.to(torch.float32)


def unpack_int8(q: torch.Tensor, s: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * s.to(dtype)
