"""Tiled matrix product with the int8-weight variant — kernel K4 of the port.

The CUDA kernel (``csrc/matmul.cu``) replaces the TPU kernel
``matmul_pallas`` (``repro/kernels/matmul.py``, DEFA's "MM mode"):
``x (M, K) @ w (K, N)`` with a float32 accumulator, written in
``x.dtype``. bf16 operands multiply in bf16 and sum in float32; an int8
``w`` comes with a per-column ``w_scale (1, N)`` float32 and is
dequantized inside the kernel, after which x and the dequantized w meet
in a float32 product, as the TPU kernel's ``_mm_q_kernel`` does.

:func:`matmul` checks its operands and takes the plain PyTorch version
:func:`matmul_plain` only when the tensors lie on the CPU; for CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_decode import refuse_autograd
from repro_torch.kernels.msgs_fused import (check_device, raise_on_error,
                                            stream_ptr)

#: Number of CUDA kernel launches made by :func:`matmul`.
LAUNCHES = 0

#: dtype -> the C entry's ``x_dtype`` / ``w_dtype`` code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def _launch(x, w, w_scale) -> torch.Tensor:
    global LAUNCHES
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _entry()(DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], x.data_ptr(),
                        w.data_ptr(), None if w_scale is None else w_scale.data_ptr(),
                        out.data_ptr(), m, n, k, stream_ptr(x.device))
    LAUNCHES += 1
    raise_on_error(code, "matmul")
    return out


def matmul(x, w, w_scale: Optional[torch.Tensor] = None, *, bm: int = 128,
           bn: int = 128, bk: int = 128) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` [with ``w_scale (1, N)`` float32 if ``w`` is
    int8], float32 accumulator, output in ``x.dtype``. ``bm``/``bn``/``bk``
    are the reference's tile sizes; they change only the order of the
    float32 sum (the plain version sums K in ``bk`` steps, the kernel in
    its own fixed tiles). CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _check(x, w, w_scale, bm, bn, bk)
    if x.device.type == "cpu":
        return matmul_plain(x, w, w_scale, bm=bm, bn=bn, bk=bk)
    return _launch(x, w, w_scale)
