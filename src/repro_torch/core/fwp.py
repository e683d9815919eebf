"""Frequency-Weighted fmap Pruning (FWP) — port of repro/core/fwp.py.

Block k counts how often bilinear interpolation touched each pixel;
block k+1 prunes pixels below ``T_l = k_h · mean_l(F)`` (Eq. 2). ``mask``
mode zeroes them; ``compact`` mode keeps a static-capacity, raster-sorted
keep-list per level and routes every pruned pixel to a zero sentinel
slot. Streaming video integrates the counts in an EMA
(:func:`ema_update`) and decides the keep set with hysteresis
(:func:`build_fwp_state_hysteresis`), so the slot geometry stays stable
between frames; :func:`copy_fwp_state` writes a new decision into the
standing state a captured streaming graph reads.

The per-level capacity top-k uses the stable sort of
:func:`repro_torch.core.pap.topk_stable`, so ``keep_idx`` and
``pix2slot`` equal the reference's exactly even though every
zero-frequency pixel ties.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pap import topk_stable


class FWPState(NamedTuple):
    """Mask/keep-list produced by block k, consumed by block k+1."""
    keep_mask: torch.Tensor             # (B, N_in) bool — mask semantics
    keep_idx: Optional[torch.Tensor]    # (B, cap) int32 — compact mode
    pix2slot: Optional[torch.Tensor]    # (B, N_in) int32; pruned -> cap
    freq: torch.Tensor                  # (B, N_in) float32 raw counts


def level_starts(level_shapes: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, int]:
    sizes = [h * w for h, w in level_shapes]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    return starts, int(sum(sizes))


def level_capacities(level_shapes, capacity: float) -> list:
    return [max(1, int(round(capacity * h * w))) for h, w in level_shapes]


def count_frequency(corner_idx: torch.Tensor, corner_valid: torch.Tensor,
                    n_in: int) -> torch.Tensor:
    """Scatter-add the sampled-times counter F: (B, M) clamped flat pixel
    indices and 0/1 weights -> (B, n_in) float32 counts. The counts are
    integers below 2^24, so the sum is exact in any order."""
    b = corner_idx.shape[0]
    freq = torch.zeros((b, n_in), dtype=torch.float32, device=corner_idx.device)
    return freq.scatter_add_(1, corner_idx.long(),
                             corner_valid.to(torch.float32))


def _per_level_threshold(freq: torch.Tensor, level_shapes,
                         k: float) -> torch.Tensor:
    """T_l = k * mean_l(F), broadcast back to (B, N_in) (Eq. 2)."""
    starts, _ = level_starts(level_shapes)
    pieces = []
    for (h, w), s in zip(level_shapes, starts):
        f_l = freq[:, int(s):int(s) + h * w]
        t_l = k * f_l.mean(dim=1, keepdim=True)
        pieces.append(t_l.expand(f_l.shape))
    return torch.cat(pieces, dim=1)


def build_fwp_state(freq: torch.Tensor, level_shapes, *, k: float, mode: str,
                    capacity: float = 0.6) -> FWPState:
    thresholds = _per_level_threshold(freq, level_shapes, k)
    keep_mask = freq >= thresholds
    if mode == "mask":
        return FWPState(keep_mask=keep_mask, keep_idx=None, pix2slot=None,
                        freq=freq)
    if mode != "compact":
        raise ValueError(f"unknown FWP mode {mode!r}")
    # above-threshold pixels rank first, most frequently sampled first;
    # below-threshold pixels may pad the capacity but are never routed to
    score = freq + keep_mask.to(torch.float32) * (freq.max() + 1.0)
    return _compact_from_scores(freq, score, keep_mask, level_shapes, capacity)


def _compact_from_scores(freq: torch.Tensor, score: torch.Tensor,
                         keep_mask: torch.Tensor, level_shapes,
                         capacity: float) -> FWPState:
    """Per-level capacity top-k on ``score``, raster-sorted slots, and
    pix2slot with sentinel routing for every below-threshold pixel."""
    starts, n_in = level_starts(level_shapes)
    caps = level_capacities(level_shapes, capacity)
    cap_total = sum(caps)
    b = freq.shape[0]
    dev = freq.device

    keep_parts, slot_parts = [], []
    slot_off = 0
    for (h, w), s, c in zip(level_shapes, starts, caps):
        score_l = score[:, int(s):int(s) + h * w]
        _, idx_l = topk_stable(score_l, c)                       # (B, c)
        idx_l, _ = torch.sort(idx_l, dim=1)                      # raster order
        keep_parts.append(idx_l.to(torch.int32) + int(s))
        slot_parts.append(slot_off + torch.arange(c, dtype=torch.int32,
                                                  device=dev))
        slot_off += c
    keep_idx = torch.cat(keep_parts, dim=1)                      # (B, cap)
    slots = torch.cat(slot_parts).expand(keep_idx.shape)

    surviving = torch.gather(keep_mask, 1, keep_idx.long())
    slot_or_sentinel = torch.where(surviving, slots,
                                   torch.full_like(slots, cap_total))
    pix2slot = torch.full((b, n_in), cap_total, dtype=torch.int32, device=dev)
    pix2slot.scatter_(1, keep_idx.long(), slot_or_sentinel)
    return FWPState(keep_mask=keep_mask, keep_idx=keep_idx,
                    pix2slot=pix2slot, freq=freq)


def ema_update(ema: torch.Tensor, freq: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """Streaming frequency score: ``ema' = (1-alpha)·ema + alpha·freq``."""
    a = float(alpha)
    return (1.0 - a) * ema + a * freq


def build_fwp_state_hysteresis(ema: torch.Tensor, level_shapes, *,
                               k_enter: float, k_exit: float, mode: str,
                               capacity: float = 0.6,
                               prev: Optional[FWPState] = None) -> FWPState:
    """FWP keep decision with per-pixel hysteresis for streaming reuse.

    A pixel enters the keep set when its EMA score clears ``T_enter =
    k_enter·mean_l`` and leaves it only below ``T_exit = k_exit·mean_l``;
    in between the previous decision sticks. Compact mode ranks the
    capacity fill in tiers (strictly ordered because m > max(ema)):
    kept incumbent (ema+3m) > kept newcomer (ema+2m) > unkept incumbent
    (ema+m) > unkept padding (ema), so a kept incumbent keeps its slot
    and ``keep_idx`` churn follows mask churn. ``m`` is the maximum over
    the whole batch, as in the reference."""
    if k_enter < k_exit:
        raise ValueError(
            f"hysteresis needs k_enter >= k_exit (got {k_enter} < {k_exit})")
    t_enter = _per_level_threshold(ema, level_shapes, k_enter)
    t_exit = _per_level_threshold(ema, level_shapes, k_exit)
    if prev is None:
        prev_kept = torch.zeros(ema.shape, dtype=torch.bool, device=ema.device)
    else:
        prev_kept = prev.keep_mask
    keep_mask = (ema >= t_enter) | (prev_kept & (ema >= t_exit))
    if mode == "mask":
        return FWPState(keep_mask=keep_mask, keep_idx=None, pix2slot=None,
                        freq=ema)
    if mode != "compact":
        raise ValueError(f"unknown FWP mode {mode!r}")
    incumbent = torch.zeros(ema.shape, dtype=torch.bool, device=ema.device)
    if prev is not None and prev.keep_idx is not None:
        incumbent.scatter_(1, prev.keep_idx.long(), True)
    m = ema.max() + 1.0
    score = ema + keep_mask.to(torch.float32) * (2.0 * m) \
        + incumbent.to(torch.float32) * m
    return _compact_from_scores(ema, score, keep_mask, level_shapes, capacity)


def copy_fwp_state(dst: Optional[FWPState], src: FWPState) -> FWPState:
    """``src``'s values written into ``dst``'s tensors in place, so that
    whatever reads ``dst`` (a captured streaming graph) keeps reading the
    same addresses; returns ``dst``. Without a ``dst`` of ``src``'s
    layout, an owned copy of ``src``."""
    def same(a, b):
        return (a is None) == (b is None) and (
            a is None or (a.shape == b.shape and a.dtype == b.dtype))
    if dst is None or not all(same(a, b) for a, b in zip(dst, src)):
        return FWPState(*(None if t is None
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in src))
    for d, s in zip(dst, src):
        if d is not None:
            d.copy_(s)
    return dst


def fwp_sparsity(state: FWPState) -> torch.Tensor:
    """Fraction of pixels pruned."""
    return 1.0 - state.keep_mask.to(torch.float32).mean()
