"""Error-feedback int8 gradient compression for the cross-pod all-reduce
(port of ``repro/optim/compress.py``).

Quantize the cross-pod reduction to int8 with an error-feedback residual,
so the quantization noise is re-injected next step instead of lost:

    g_local = <psum over "data">              # full precision within pod
    g_global, ef = compressed_psum(g_local + ef, "pod")

:func:`compressed_psum_body` is the rank body (it runs under
``distributed.collectives.run_spmd`` or ``run_in_process``): a MAX
all-reduce of the scale, an int32 SUM all-reduce of the codes, a divide
by the group size, and the residual. The pure quantize/dequantize pieces
are exposed separately so the error-feedback contraction can be checked
without a mesh."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import collectives as C


class ErrorFeedback(NamedTuple):
    residual: torch.Tensor


def quantize_grad(g: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor quantization -> (int32 codes, f32 scale)."""
    qmax = (1 << (bits - 1)) - 1
    scale = torch.clamp(g.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int32)
    return q, scale.to(torch.float32)


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_body(ctx: C.RankContext, g: torch.Tensor, axis_name: str,
                         bits: int = 8,
                         residual: Optional[torch.Tensor] = None):
    """Rank body: int-quantized psum over ``axis_name`` with error
    feedback. Returns (mean-reduced g (f32), new residual, the codes
    this rank sent)."""
    if residual is not None:
        g = g.to(torch.float32) + residual
    q, scale = quantize_grad(g, bits)
    # max-reduce scales so all ranks dequantize identically, then int psum
    scale = yield C.pmax(axis_name, scale)
    qmax = (1 << (bits - 1)) - 1
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int32)
    sent = q.to(torch.float32) * scale
    new_residual = g - sent                     # what this rank failed to send
    total = (yield C.psum(axis_name, q)).to(torch.float32) * scale
    return total / ctx.size[axis_name], new_residual, q


def compressed_psum(g: torch.Tensor, axis_name: str, mesh, bits: int = 8,
                    residual: Optional[torch.Tensor] = None):
    """This process's rank of the compressed psum over ``mesh`` (a
    ``DeviceMesh``): (mean-reduced g (f32), new residual)."""
    ctx = C.rank_context(mesh)
    out, res, _ = C.run_spmd(
        compressed_psum_body(ctx, g, axis_name, bits, residual), mesh)
    return out, res
