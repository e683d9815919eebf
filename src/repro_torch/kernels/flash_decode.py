"""One-token GQA flash-decode attention — kernel K5 of the port.

The CUDA kernel (``csrc/flash_decode.cu``) replaces the TPU kernel
``flash_decode_pallas`` (``repro/kernels/flash_decode.py``): one new
query token per sequence, ``q (B, Hq, Dh)``, against a ``(B, W, Hkv, Dh)``
KV cache with a per-slot validity mask ``valid (B, W)``. It computes
what the TPU kernel computes, which in two cases is not what the
reference's oracle ``flash_decode_ref`` computes:

  * query head ``h`` reads KV head ``h // ceil(Hq / Hkv)`` (the oracle:
    ``min(h // (Hq // Hkv), Hkv - 1)``; they differ when Hkv does not
    divide Hq), unless the caller names each query head's KV head
    (``kv_heads``);
  * W is padded to a multiple of ``min(chunk, W)`` with invalid zero
    slots, and a row with no valid slot averages V over real and padded
    slots alike (the oracle: over the W real slots).

:func:`flash_decode` checks its operands and takes the plain PyTorch
version :func:`flash_decode_plain` only when the tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises. The kernel splits W
over blocks (:func:`decode_splits`), reads the K and V rows of the valid
slots only (a split whose slots are all valid as whole TMA tiles), and
merges the splits in a second, parallel pass; ``LAUNCHES`` counts
wrapper calls that launched.

``kv_heads`` gives the model's own map: query head ``h`` reads the
stored KV head ``kv_heads[h]`` of ``k`` / ``v``, whose third dim is the
cache row's head count. Padded query heads that clamp to the last KV
head, and a tensor-parallel rank's query heads reading a block of KV
heads from the middle of a cache that stores more (in place, no copy),
are both such maps. The kernel takes it as a head table
(:func:`head_table`): one entry per run of consecutive query heads on
one KV head, passed by value in the launch's parameters. A run is cut
at the width of the split pass that serves the call
(:func:`split_pass`): MAX_REP_MMA = 16 query heads on the tensor-core
pass (bf16, Dh a multiple of 32: one block reads a KV head once for its
whole GQA group), MAX_REP = 4 on the CUDA-core pass. The launch is the
operator ``repro_torch::flash_decode`` (:mod:`repro_torch.kernels.library`).

The partial mode (``partial=True``) returns each row's float32 output,
not rounded to the input dtype, and its log-sum-exp ``lse = m + log(l)``
(B, Hq): a rank that holds a slice of the cache's slots decodes over
its slice, and :func:`merge_rank_partials` merges the ranks' rows in
rank order. A row with no valid slot carries no weight there: a zero
output and ``lse = -inf`` (the normal mode averages V over it, as the
TPU kernel does). ``LAUNCHES_PARTIAL`` counts that mode's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.library import kernel_op, no_tensor, on_card
from repro_torch.kernels.msgs_fused import (check_device, raise_on_error,
                                            sm_count, stream_ptr)

#: Number of CUDA kernel launches made by :func:`flash_decode` (one per
#: call: the split pass and its merge).
LAUNCHES = 0
#: Launches of the partial mode (``partial=True``), counted apart.
LAUNCHES_PARTIAL = 0

#: q / k / v dtype -> the C entry's ``dtype`` code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128               # kMaxDh in flash_decode.cu
NEG = -1e30                      # the TPU kernel's mask and initial max
MAX_REP = 4                      # kMaxRep: query heads per CUDA-core block
MAX_REP_MMA = 16                 # kMmaRows: query heads per tensor-core block
MAX_SPLIT = 512                  # kMaxSplit: slots per split, at most
MIN_SPLIT = 64                   # the shortest split decode_splits picks
MAX_SPLITS = 1024                # kMaxMergeSplits: splits the merge takes
MAX_ENTRIES = 512                # kMaxEntries: head-table entries
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
    """Blocks per KV head on the CUDA-core pass: its ``n_rep`` query heads
    in groups of MAX_REP (the tensor-core pass takes a group of up to
    MAX_REP_MMA in one block)."""
    return -(-n_rep_of(hq, hkv) // MAX_REP)


def split_pass(dtype: torch.dtype, dh: int, aligned: bool = True) -> str:
    """The split pass the kernel runs for operands of ``dtype`` and head
    dim ``dh`` (``aligned``: K and V start on 16 bytes), as
    ``flash_decode_forward`` picks it: "tensor_core" for bf16 rows whose
    Dh is a multiple of 32, else "cuda_core"."""
    return ("tensor_core" if dtype == torch.bfloat16 and dh % 32 == 0
            and aligned else "cuda_core")


def pass_max_rep(dtype: torch.dtype, dh: int, aligned: bool = True) -> int:
    """Query heads per head-table entry on the pass that serves the call."""
    return (MAX_REP_MMA if split_pass(dtype, dh, aligned) == "tensor_core"
            else MAX_REP)


def n_rep_of(hq: int, hkv: int) -> int:
    """Query heads per KV head, rounded up (the TPU kernel's ``n_rep``)."""
    return max(1, -(-hq // hkv))


def default_kv_heads(hq: int, hkv: int) -> tuple:
    """The TPU kernel's map: query head h reads KV head h // n_rep."""
    n_rep = n_rep_of(hq, hkv)
    return tuple(h // n_rep for h in range(hq))


@functools.lru_cache(maxsize=None)
def head_table(kv_heads: tuple, max_rep: int = MAX_REP) -> tuple:
    """K5's head table for the map ``kv_heads`` (query head -> stored KV
    head): entries ``(g << 16) | (h0 << 4) | (nh % 16)``, one per run of
    at most ``max_rep`` (<= 16) consecutive query heads h0 .. h0 + nh - 1
    that all read KV head g, in query-head order (a run of 16 stores 0 in
    its low bits)."""
    out, h = [], 0
    while h < len(kv_heads):
        g, nh = kv_heads[h], 1
        while nh < max_rep and h + nh < len(kv_heads) and kv_heads[h + nh] == g:
            nh += 1
        out.append((int(g) << 16) | (h << 4) | (nh % 16))
        h += nh
    return tuple(out)


def launch_table(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_heads=None) -> tuple:
    """The head table a launch on these operands takes: the map
    ``kv_heads`` (default the TPU kernel's) in runs of the serving pass's
    width. Alignment is read from the storage offsets (PyTorch's
    allocations start on 16 bytes), so fake tensors plan alike."""
    aligned = all(t.storage_offset() * t.element_size() % 16 == 0
                  for t in (k, v))
    kv = (default_kv_heads(q.shape[1], k.shape[2]) if kv_heads is None
          else tuple(kv_heads))
    return head_table(kv, pass_max_rep(q.dtype, q.shape[2], aligned))


@functools.lru_cache(maxsize=None)
def _c_table(table: tuple):
    """The table as the C entry's uint32 array (kept alive by the cache)."""
    return (ctypes.c_uint32 * len(table))(*table)


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


def _check(q, k, v, valid, chunk, kv_heads=None) -> None:
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
    if kv_heads is not None and (
            len(kv_heads) != hq or hq >= 4096
            or any(not 0 <= int(g) < k.shape[2] for g in kv_heads)):
        raise ValueError(f"{name}: kv_heads must name one of the {k.shape[2]} "
                         f"stored KV heads for each of the {hq} query heads, "
                         f"got {tuple(kv_heads)}")
    for label, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name}: {label} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def flash_decode_plain(q, k, v, valid, *, chunk: int = 512,
                       kv_heads=None, partial: bool = False):
    """Plain PyTorch version: the TPU kernel's function in one pass. The
    query heads are padded to ``Hkv * n_rep`` and grouped per KV head
    (the kernel's broadcast ``rep``), or with ``kv_heads`` each reads its
    own KV head; each score is the float32 dot product rounded to the
    input dtype and scaled by ``1/sqrt(Dh)``, invalid and padded slots
    score -1e30, the softmax's max starts at -1e30, P.V is summed in
    float32 and the denominator is clamped at 1e-20. Returns (B, Hq, Dh)
    in ``q.dtype``; with ``partial``, (the float32 output, lse (B, Hq)),
    a row with no valid slot zero with lse -inf."""
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    pad = chunk_padding(w, chunk)
    if kv_heads is None:
        n_rep = n_rep_of(hq, hkv)
        qg = F.pad(q.float(), (0, 0, 0, hkv * n_rep - hq)).view(b, hkv, n_rep, dh)
        kg, vg = k.float(), v.float()
    else:
        idx = torch.as_tensor(list(kv_heads), dtype=torch.long, device=k.device)
        qg = q.float()[:, :, None]                     # a group of one per head
        kg, vg = k.float()[:, :, idx], v.float()[:, :, idx]
    s = torch.einsum("bgrd,bwgd->bgrw", qg, kg)
    s = s.to(q.dtype).float() * (1.0 / math.sqrt(dh))
    s = torch.where(valid[:, None, None, :], s, NEG)
    s = F.pad(s, (0, pad), value=NEG)                  # padded slots
    mx = torch.clamp(s.amax(-1, keepdim=True), min=NEG)
    p = torch.exp(s - mx)
    den = p.sum(-1, keepdim=True)
    acc = torch.einsum("bgrw,bwgd->bgrd", p[..., :w], vg)
    out = (acc / torch.clamp(den, min=1e-20)).reshape(b, -1, dh)[:, :hq]
    if not partial:
        return out.to(q.dtype)
    lse = (mx + torch.log(den)).reshape(b, -1)[:, :hq]
    empty = ~valid.any(1)[:, None]
    return (torch.where(empty[..., None], 0.0, out),
            torch.where(empty, -math.inf, lse))


def merge_rank_partials(outs: Sequence[torch.Tensor],
                        lses: Sequence[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """The attention over a cache whose slots lie split over ranks, from
    each rank's partial (:func:`flash_decode` with ``partial=True``)
    listed in rank order: ``outs`` (B, Hq, Dh) and ``lses`` (B, Hq),
    float32. Each row weighs ``exp(lse_r - max lse)`` (a rank with no
    valid slot weighs 0); the weighted outputs and the weights are summed
    in float32 in rank order and the quotient is rounded once to
    ``dtype``. Not a kernel: the reference's partitioner computes these
    reductions with XLA's (a row no rank holds a valid slot of comes out
    zero)."""
    top = lses[0]
    for lse in lses[1:]:
        top = torch.maximum(top, lse)
    top = torch.where(torch.isfinite(top), top, 0.0)
    num, den = None, None
    for out, lse in zip(outs, lses):
        wgt = torch.exp(lse - top)
        num = out * wgt[..., None] if num is None else num + out * wgt[..., None]
        den = wgt if den is None else den + wgt
    return (num / torch.clamp(den, min=1e-20)[..., None]).to(dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry ``flash_decode_forward``: dtype code, 9 pointers (q, k,
    v, valid, out, the partial mode's float32 output and lse, the split
    partials and the split counts), B, Hq, Hkv, Dh, W, pad, the split
    length, the scale, the head table and its length, and the stream."""
    from repro_torch.kernels.build import load_library
    fn = load_library("flash_decode").flash_decode_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _outputs(q, partial):
    """(out, lse): the input dtype's output and a placeholder, or in the
    partial mode the float32 output and (B, Hq) lse."""
    if not partial:
        return torch.empty_like(q), no_tensor(q.device)
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


def _fake(q, k, v, valid, chunk, table, partial):
    return _outputs(q, partial)


def _flops(q, k, *_, out_shape=None, **__) -> int:
    """4 operations per channel, query head and slot (the score's
    multiply-add and P.V's), every slot valid."""
    b, hq, dh = q
    return 4 * dh * hq * b * k[1]


@kernel_op("flash_decode", fake=_fake, flops=_flops)
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, chunk: int, table: List[int],
            partial: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES, LAUNCHES_PARTIAL
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    table = tuple(table)
    if len(table) > MAX_ENTRIES:
        raise ValueError(f"flash_decode: {len(table)} head-table entries; the "
                         f"kernel takes at most {MAX_ENTRIES}")
    out, lse = _outputs(q, partial)
    length, n_splits = decode_splits(b, len(table), 1, w, sm_count(q.device))
    if n_splits > MAX_SPLITS:
        raise ValueError(f"flash_decode: W {w} needs {n_splits} splits of "
                         f"{length}; the kernel merges at most {MAX_SPLITS}")
    part = torch.empty((b, hq, n_splits, dh + 2), dtype=torch.float32,
                       device=q.device)
    counts = torch.empty((b, n_splits), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        code = _entry()(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), valid.data_ptr(),
                        None if partial else out.data_ptr(),
                        out.data_ptr() if partial else None,
                        lse.data_ptr() if partial else None,
                        part.data_ptr(), counts.data_ptr(), b, hq, hkv, dh, w,
                        chunk_padding(w, chunk), length, 1.0 / math.sqrt(dh),
                        ctypes.addressof(_c_table(table)), len(table),
                        stream_ptr(q.device))
    if partial:
        LAUNCHES_PARTIAL += 1
    else:
        LAUNCHES += 1
    raise_on_error(code, "flash_decode")
    return out, lse


def flash_decode(q, k, v, valid, *, chunk: int = 512, kv_heads=None,
                 partial: bool = False):
    """Fused one-token GQA decode attention over a masked KV cache.

    ``q (B, Hq, Dh)``, ``k``/``v (B, W, Hkv, Dh)`` in float32 or bf16,
    ``valid (B, W)`` bool; ``chunk`` is the TPU kernel's KV chunk, which
    shows only in rows with no valid slot; ``kv_heads`` (Hq ints, default
    the TPU kernel's ``h // ceil(Hq / Hkv)``) names the stored KV head
    each query head reads. Returns (B, Hq, Dh) in ``q.dtype``; with
    ``partial``, the float32 output and its lse (B, Hq) (see the module
    docstring). CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    kv_heads = None if kv_heads is None else tuple(int(g) for g in kv_heads)
    _check(q, k, v, valid, chunk, kv_heads)
    if not on_card(q):
        return flash_decode_plain(q, k, v, valid, chunk=chunk,
                                  kv_heads=kv_heads, partial=partial)
    out, lse = _launch(q, k, v, valid, chunk,
                       list(launch_table(q, k, v, kv_heads)), bool(partial))
    return (out, lse) if partial else out
