"""Matrix product with the int8-weight variant — kernel K4 of the port.

The CUDA kernels (``csrc/matmul.cu``) replace the TPU kernel
``matmul_pallas`` (``repro/kernels/matmul.py``, DEFA's "MM mode"):
``x (M, K) @ w (K, N)`` with a float32 accumulator, written in
``x.dtype``. bf16 operands multiply in bf16 and sum in float32; an int8
``w`` comes with a per-column ``w_scale (1, N)`` float32.

Two routes, picked by :func:`matmul_route` from dtypes and alignment
alone, never by a failure: ``"wgmma"`` (bf16 x; TMA feeds Hopper's
tensor cores; an int8 w is widened to bf16 in shared memory and its
scale multiplies the float32 sum) and ``"simt"`` (float32 x and the
shapes TMA cannot describe; the int8 w is dequantized element by
element before a float32 product, as the TPU kernel's ``_mm_q_kernel``).

:func:`matmul` checks its operands and takes the plain PyTorch version
:func:`matmul_plain` only when the tensors lie on the CPU; for CUDA
tensors it launches a kernel or raises. ``LAUNCHES`` counts wrapper
calls that launched, ``LAUNCHES_BY_ROUTE`` the same by route. The
launch is the operator ``repro_torch::matmul``
(:mod:`repro_torch.kernels.library`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_decode import refuse_autograd
from repro_torch.kernels.library import kernel_op, on_card
from repro_torch.kernels.msgs_fused import (check_device, raise_on_error,
                                            sm_count, stream_ptr)

#: Number of CUDA kernel launches made by :func:`matmul` (one per call;
#: a split-K call's reduction pass is part of it).
LAUNCHES = 0
#: The same calls by route (see :func:`matmul_route`).
LAUNCHES_BY_ROUTE = {"wgmma": 0, "simt": 0}

#: dtype -> the C entry's ``x_dtype`` / ``w_dtype`` code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


#: the wgmma kernel's output tile and K step (``wg::kBM`` etc. in matmul.cu)
WGMMA_TILE = (128, 128, 64)
#: fewest K steps of 64 a split keeps, so that its TMA ring fills
MIN_K_TILES_PER_SPLIT = 4


def matmul_route(x: torch.Tensor, w: torch.Tensor,
                 w_scale: Optional[torch.Tensor] = None) -> str:
    """``"wgmma"`` for a bf16 x whose shapes and pointers TMA can describe
    (K % 8 == 0 and N % 8 == 0 for a bf16 w, N % 16 == 0 for int8 codes:
    16-byte row strides; 16-byte aligned x and w); ``"simt"`` for
    everything else, float32 x among it (the tensor cores would round it
    to TF32, the reference multiplies in float32)."""
    if x.dtype != torch.bfloat16:
        return "simt"
    k, n = w.shape
    if k % 8 or n % (16 if w.dtype == torch.int8 else 8):
        return "simt"
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        return "simt"
    return "wgmma"


def matmul_splits(m: int, n: int, k: int, sms: int) -> int:
    """How many blocks split K on the wgmma route, on a card of ``sms``
    SMs. A product with at least one output tile per SM is not split. Otherwise (narrow M, as in
    decode) the count minimises rounds of resident blocks (one per SM)
    times K steps per split, keeping at least ``MIN_K_TILES_PER_SPLIT``
    steps per split; ties go to fewer splits. No split is left empty."""
    bm, bn, bk = WGMMA_TILE
    tiles = -(-m // bm) * -(-n // bn)
    k_tiles = -(-k // bk)
    if tiles >= sms:
        return 1
    best, best_cost = 1, None
    for s in range(1, max(1, k_tiles // MIN_K_TILES_PER_SPLIT) + 1):
        cost = -(-tiles * s // sms) * -(-k_tiles // s)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    per = -(-k_tiles // best)
    return -(-k_tiles // per)


def _check(x, w, w_scale, bm, bn, bk) -> None:
    name = "matmul"
    refuse_autograd(name, x, w, w_scale)
    check_device(x.device, name)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x dtype {x.dtype} unsupported; expected "
                        "torch.float32 or torch.bfloat16")
    if w.dtype not in (x.dtype, torch.int8):
        raise TypeError(f"{name}: w dtype {w.dtype} must be x's ({x.dtype}) "
                        "or torch.int8")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or x.shape[1] < 1:
        raise ValueError(f"{name}: expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if (w.dtype == torch.int8) != (w_scale is not None):
        raise ValueError(f"{name}: an int8 w needs its float32 w_scale "
                         "(1, N) and a float w takes none")
    if w_scale is not None and (w_scale.dtype != torch.float32
                                or tuple(w_scale.shape) != (1, w.shape[1])):
        raise ValueError(f"{name}: w_scale must be float32 (1, {w.shape[1]}), "
                         f"got {w_scale.dtype} {tuple(w_scale.shape)}")
    if min(bm, bn, bk) < 1:
        raise ValueError(f"{name}: tile sizes must be positive, got "
                         f"bm={bm} bn={bn} bk={bk}")
    for label, t in (("x", x), ("w", w), ("w_scale", w_scale)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def dequantized(w: torch.Tensor, w_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """w as the float32 operand of the product (int8 codes times their
    column's scale, element by element)."""
    return w.float() if w_scale is None else w.float() * w_scale


def matmul_plain(x, w, w_scale: Optional[torch.Tensor] = None, *,
                 bm: int = 128, bn: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's float32 accumulator summed
    over K in steps of ``min(bk, K)`` (its K grid axis), each step a
    float32 product of x and the (dequantized) w. ``bm`` and ``bn`` only
    tile the output and do not change it. Returns (M, N) in ``x.dtype``."""
    k = x.shape[1]
    step = min(bk, k)
    xf, wf = x.float(), dequantized(w, w_scale)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, k, step):
        acc += xf[:, k0:k0 + step] @ wf[k0:k0 + step]
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry ``matmul_forward``: x and w dtype codes, 4 pointers (x,
    w, w_scale, out), M, N, K and the stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("matmul").matmul_forward
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _wgmma_entry():
    """The C entry ``matmul_wgmma_forward``: w dtype code, 5 pointers (x,
    w, w_scale, out, the split-K partials), M, N, K, splits and the
    stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("matmul").matmul_wgmma_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _fake(x, w, w_scale=None):
    return x.new_empty((x.shape[0], w.shape[1]))


def _flops(x, w, *_, out_shape=None, **__) -> int:
    return 2 * x[0] * x[1] * w[1]


@kernel_op("matmul", fake=_fake, flops=_flops)
def _launch(x: torch.Tensor, w: torch.Tensor,
            w_scale: Optional[torch.Tensor]) -> torch.Tensor:
    global LAUNCHES
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    route = matmul_route(x, w, w_scale)
    scale_ptr = None if w_scale is None else w_scale.data_ptr()
    with torch.cuda.device(x.device):
        if route == "wgmma":
            splits = matmul_splits(m, n, k, sm_count(x.device))
            partial = (torch.empty((splits, m, n), dtype=torch.float32,
                                   device=x.device) if splits > 1 else None)
            code = _wgmma_entry()(
                DTYPE_CODES[w.dtype], x.data_ptr(), w.data_ptr(), scale_ptr,
                out.data_ptr(), None if partial is None else partial.data_ptr(),
                m, n, k, splits, stream_ptr(x.device))
        else:
            code = _entry()(DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype],
                            x.data_ptr(), w.data_ptr(), scale_ptr,
                            out.data_ptr(), m, n, k, stream_ptr(x.device))
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[route] += 1
    raise_on_error(code, f"matmul ({route})")
    return out


def matmul(x, w, w_scale: Optional[torch.Tensor] = None, *, bm: int = 128,
           bn: int = 128, bk: int = 128) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` [with ``w_scale (1, N)`` float32 if ``w`` is
    int8], float32 accumulator, output in ``x.dtype``. ``bm``/``bn``/``bk``
    are the reference's tile sizes; they change only the order of the
    float32 sum (the plain version sums K in ``bk`` steps, the kernels in
    their own fixed tiles). CUDA tensors launch the kernel of
    :func:`matmul_route`'s route; CPU tensors run the plain version."""
    _check(x, w, w_scale, bm, bn, bk)
    if not on_card(x):
        return matmul_plain(x, w, w_scale, bm=bm, bn=bn, bk=bk)
    return _launch(x, w, w_scale)
