"""Hand-rolled AdamW on parameter trees (port of repro/optim/adamw.py):
float32 moments, decoupled weight decay, global-norm clipping, linear
warmup then cosine decay.

Parameters, gradients and moments are trees of nested dicts and lists
of tensors, as the detector's params are; the update is functional (new
tensors, the inputs untouched), as in the reference. Dict leaves are
visited in sorted key order, as ``jax.tree.leaves`` visits them, so the
global norm sums in the reference's order."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, List

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict/list/tuple tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: Iterable) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf of ``tree``."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Learning rate after ``step`` updates (float32 scalar tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params: Any) -> dict:
    """Zero float32 moments beside every leaf, and a step count of 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def adamw_update(params: Any, grads: Any, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, metrics {grad_norm, lr})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (update + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m_new, v_new

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    rebuild = lambda i: tree_unflatten(params, (o[i] for o in out))
    new_state = {"m": rebuild(1), "v": rebuild(2), "step": step}
    return rebuild(0), new_state, {"grad_norm": gnorm, "lr": lr}
