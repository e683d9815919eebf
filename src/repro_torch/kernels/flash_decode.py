"""One-token GQA flash-decode attention — kernel K5 of the port.

The CUDA kernel (``csrc/flash_decode.cu``) replaces the TPU kernel
``flash_decode_pallas`` (``repro/kernels/flash_decode.py``): one new
query token per sequence, ``q (B, Hq, Dh)``, against a ``(B, W, Hkv, Dh)``
KV cache with a per-slot validity mask ``valid (B, W)``. It computes
what the TPU kernel computes, which in two cases is not what the
reference's oracle ``flash_decode_ref`` computes:

  * query head ``h`` reads KV head ``h // ceil(Hq / Hkv)`` (the oracle:
    ``min(h // (Hq // Hkv), Hkv - 1)``; they differ when Hkv does not
    divide Hq);
  * W is padded to a multiple of ``min(chunk, W)`` with invalid zero
    slots, and a row with no valid slot averages V over real and padded
    slots alike (the oracle: over the W real slots).

:func:`flash_decode` checks its operands and takes the plain PyTorch
version :func:`flash_decode_plain` only when the tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises. The kernel splits W
over blocks (:func:`decode_splits`), reads the K and V rows of the valid
slots only, and merges the splits in a second pass; ``LAUNCHES`` counts
wrapper calls that launched. The launch is the operator
``repro_torch::flash_decode`` (:mod:`repro_torch.kernels.library`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.library import kernel_op, on_card
from repro_torch.kernels.msgs_fused import (check_device, raise_on_error,
                                            sm_count, stream_ptr)

#: Number of CUDA kernel launches made by :func:`flash_decode` (one per
#: call: the split pass and its merge).
LAUNCHES = 0

#: q / k / v dtype -> the C entry's ``dtype`` code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128               # kMaxDh in flash_decode.cu
NEG = -1e30                      # the TPU kernel's mask and initial max
MAX_REP = 4                      # kMaxRep: query heads per block
MAX_SPLIT = 512                  # kMaxSplit: slots per split, at most
MIN_SPLIT = 64                   # the shortest split decode_splits picks
MAX_SPLITS = 1024                # kMaxMergeSplits: splits the merge takes
BLOCKS_PER_SM = 4                # the grid decode_splits aims at, per SM


def decode_splits(b: int, hkv: int, n_groups: int, w: int, sms: int) -> tuple:
    """(split length, number of splits) for K5's grid over (split, b, KV
    head, query-head group) on a card of ``sms`` SMs: the longest split
    of MAX_SPLIT, halved down to MIN_SPLIT, that gives at least
    BLOCKS_PER_SM blocks per SM (short
    splits also bound the slots the busiest block walks when the valid
    slots bunch together, as in a served cache). The splits cover W
    exactly; the last one may be ragged. Lengths are multiples of 32 (the
    kernel compacts the mask 32 slots at a time)."""
    blocks = b * hkv * n_groups
    length = MAX_SPLIT
    while length > MIN_SPLIT and blocks * -(-w // length) < BLOCKS_PER_SM * sms:
        length //= 2
    return length, -(-w // length)


def head_groups(hq: int, hkv: int) -> int:
    """Blocks per KV head: its ``n_rep`` query heads in groups of MAX_REP."""
    return -(-n_rep_of(hq, hkv) // MAX_REP)


def n_rep_of(hq: int, hkv: int) -> int:
    """Query heads per KV head, rounded up (the TPU kernel's ``n_rep``)."""
    return max(1, -(-hq // hkv))


def chunk_padding(w: int, chunk: int) -> int:
    """Invalid zero slots the TPU kernel appends to reach a multiple of
    ``min(chunk, W)``."""
    return (-w) % min(chunk, w)


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Forward-only kernels (K4, K5) raise under autograd instead of
    returning an output with no gradient path, as the reference's
    ``pallas_call`` has no autodiff rule. Checked on both devices."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{name} is forward-only and cannot be "
                           "differentiated")


def _check(q, k, v, valid, chunk) -> None:
    name = "flash_decode"
    refuse_autograd(name, q, k, v)
    check_device(q.device, name)
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} unsupported; expected one "
                        f"of {list(DTYPE_CODES)}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q must be (B, Hq, Dh) and k, v (B, W, Hkv, "
                         f"Dh), got {tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] < 1 or k.shape[2] < 1:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"{name}: v {tuple(v.shape)} != k {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} > {MAX_HEAD_DIM}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k.shape[1]):
        raise ValueError(f"{name}: valid must be bool (B={b}, W={k.shape[1]}), "
                         f"got {valid.dtype} {tuple(valid.shape)}")
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be positive, got {chunk}")
    for label, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name}: {label} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def flash_decode_plain(q, k, v, valid, *, chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's function in one pass. The
    query heads are padded to ``Hkv * n_rep`` and grouped per KV head
    (the kernel's broadcast ``rep``), each score is the float32 dot
    product rounded to the input dtype and scaled by ``1/sqrt(Dh)``,
    invalid and padded slots score -1e30, the softmax's max starts at
    -1e30, P.V is summed in float32 and the denominator is clamped at
    1e-20. Returns (B, Hq, Dh) in ``q.dtype``."""
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    n_rep = n_rep_of(hq, hkv)
    pad = chunk_padding(w, chunk)
    qg = F.pad(q.float(), (0, 0, 0, hkv * n_rep - hq)).view(b, hkv, n_rep, dh)
    s = torch.einsum("bgrd,bwgd->bgrw", qg, k.float())
    s = s.to(q.dtype).float() * (1.0 / math.sqrt(dh))
    s = torch.where(valid[:, None, None, :], s, NEG)
    s = F.pad(s, (0, pad), value=NEG)                  # padded slots
    mx = torch.clamp(s.amax(-1, keepdim=True), min=NEG)
    p = torch.exp(s - mx)
    den = p.sum(-1, keepdim=True)
    acc = torch.einsum("bgrw,bwgd->bgrd", p[..., :w], v.float())
    out = acc / torch.clamp(den, min=1e-20)
    return out.reshape(b, hkv * n_rep, dh)[:, :hq].to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry ``flash_decode_forward``: dtype code, 7 pointers (q, k,
    v, valid, out, the partials and the split counts), B, Hq, Hkv, Dh, W,
    n_rep, pad, the split length, the scale and the stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("flash_decode").flash_decode_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _fake(q, k, v, valid, chunk):
    return torch.empty_like(q)


def _flops(q, k, *_, out_shape=None, **__) -> int:
    """4 operations per channel, query head and slot (the score's
    multiply-add and P.V's), every slot valid."""
    b, hq, dh = q
    return 4 * dh * hq * b * k[1]


@kernel_op("flash_decode", fake=_fake, flops=_flops)
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, chunk: int) -> torch.Tensor:
    global LAUNCHES
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    out = torch.empty_like(q)
    length, n_splits = decode_splits(b, hkv, head_groups(hq, hkv), w,
                                     sm_count(q.device))
    if n_splits > MAX_SPLITS:
        raise ValueError(f"flash_decode: W {w} needs {n_splits} splits of "
                         f"{length}; the kernel merges at most {MAX_SPLITS}")
    part = torch.empty((b, hq, n_splits, dh + 2), dtype=torch.float32,
                       device=q.device)
    counts = torch.empty((b, n_splits), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        code = _entry()(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                        part.data_ptr(), counts.data_ptr(), b, hq, hkv, dh, w,
                        n_rep_of(hq, hkv), chunk_padding(w, chunk), length,
                        1.0 / math.sqrt(dh), stream_ptr(q.device))
    LAUNCHES += 1
    raise_on_error(code, "flash_decode")
    return out


def flash_decode(q, k, v, valid, *, chunk: int = 512) -> torch.Tensor:
    """Fused one-token GQA decode attention over a masked KV cache.

    ``q (B, Hq, Dh)``, ``k``/``v (B, W, Hkv, Dh)`` in float32 or bf16,
    ``valid (B, W)`` bool; ``chunk`` is the TPU kernel's KV chunk, which
    shows only in rows with no valid slot. Returns (B, Hq, Dh) in
    ``q.dtype``. CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check(q, k, v, valid, chunk)
    if not on_card(q):
        return flash_decode_plain(q, k, v, valid, chunk=chunk)
    return _launch(q, k, v, valid, chunk)
