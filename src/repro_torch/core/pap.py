"""Probability-Aware Point pruning (PAP) — port of repro/core/pap.py.

``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order for ties. Probabilities are 12-bit
fake-quantized before PAP, so ties are common: :func:`topk_stable` is a
stable descending sort followed by a slice, which reproduces
``lax.top_k`` exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PAPSelection(NamedTuple):
    probs: torch.Tensor       # (B, Nq, H, K) surviving probabilities
    point_idx: torch.Tensor   # (B, Nq, H, K) int32 index into the L*P axis
    keep_frac: torch.Tensor   # scalar — fraction of points kept


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``lax.top_k``'s tie order (lower
    index first). Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _all_points(probs: torch.Tensor) -> torch.Tensor:
    lp = probs.shape[-1]
    return torch.arange(lp, dtype=torch.int32,
                        device=probs.device).expand(probs.shape)


def pap_threshold_select(probs: torch.Tensor, threshold: float) -> PAPSelection:
    """Zero near-zero probabilities; keeps the full L*P axis (K = L*P)."""
    mask = probs > threshold
    kept = torch.where(mask, probs, torch.zeros_like(probs))
    return PAPSelection(probs=kept, point_idx=_all_points(probs),
                        keep_frac=mask.to(torch.float32).mean())


def pap_topk_select(probs: torch.Tensor, k: int,
                    threshold: float = 0.0) -> PAPSelection:
    """Keep the top-K points per (query, head); optional threshold on top."""
    top_p, top_i = topk_stable(probs, k)
    if threshold > 0.0:
        keep = top_p > threshold
        top_p = torch.where(keep, top_p, torch.zeros_like(top_p))
        kept_frac = keep.to(torch.float32).mean() * (k / probs.shape[-1])
    else:
        kept_frac = torch.tensor(k / probs.shape[-1], dtype=torch.float32,
                                 device=probs.device)
    return PAPSelection(probs=top_p, point_idx=top_i.to(torch.int32),
                        keep_frac=kept_frac)


def pap_select(probs: torch.Tensor, mode: str, *, threshold: float,
               k: int) -> PAPSelection:
    if mode == "off":
        return PAPSelection(probs=probs, point_idx=_all_points(probs),
                            keep_frac=torch.tensor(1.0, dtype=torch.float32,
                                                   device=probs.device))
    if mode == "threshold":
        return pap_threshold_select(probs, threshold)
    if mode == "topk":
        return pap_topk_select(probs, k, threshold=0.0)
    raise ValueError(f"unknown PAP mode {mode!r}")
