"""Hand-rolled AdamW on parameter trees (port of repro/optim/adamw.py):
float32 moments, decoupled weight decay, global-norm clipping, linear
warmup then cosine decay.

Parameters, gradients and moments are trees of nested dicts and lists
of tensors, as the detector's params are; :func:`adamw_update` is
functional (new tensors, the inputs untouched), as in the reference, and
:func:`adamw_update_` writes the same values in place (a captured train
step's standing state). Dict leaves are
visited in sorted key order, as ``jax.tree.leaves`` visits them, so the
global norm sums in the reference's order."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Iterator, List, Optional

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


def _build(t: Any, it: Iterator) -> Any:
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_unflatten(like: Any, leaves: Iterable) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order. (A recursive closure here would form a
    reference cycle through its own cell and keep every leaf alive until
    the cyclic garbage collector runs: gigabytes of a train step's
    gradients and states.)"""
    return _build(like, iter(leaves))


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


def _update_scalars(grads: Any, state: dict, cfg: OptConfig,
                    grad_norm: Optional[torch.Tensor]):
    """(grad_norm, clip scale, new step count, lr, bc1, bc2)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    bc1 = 1.0 - cfg.beta1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.beta2 ** step.to(torch.float32)
    return gnorm, scale, step, lr, bc1, bc2


def _leaf_update(p, g, m, v, scale, lr, bc1, bc2, cfg: OptConfig, *,
                 in_place: bool = False):
    """One leaf's (p', m', v'):
    m' = b1 m + (1 - b1) g;  v' = b2 v + (1 - b2) g^2;
    p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p),
    op for op, written in place into the step's own temporaries so that a
    leaf of a few GB needs few copies (each in-place op rounds as its
    out-of-place form does). ``in_place``: m and v are the moments
    themselves (``mul_``), bitwise the new tensors the default makes."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.to(torch.float32) * scale
    m_new = (m.mul_(b1) if in_place else torch.mul(m, b1)) \
        .add_(torch.mul(g, 1 - b1))
    v_new = (v.mul_(b2) if in_place else torch.mul(v, b2)) \
        .add_(torch.square(g).mul_(1 - b2))
    del g
    den = torch.div(v_new, bc2).sqrt_().add_(cfg.eps)
    update = torch.div(m_new, bc1).div_(den)
    del den
    p32 = p.to(torch.float32)
    update.add_(torch.mul(p32, cfg.weight_decay)).mul_(lr)
    p_new = update.neg_().add_(p32)                      # p32 - update
    return p_new.to(p.dtype), m_new, v_new


def adamw_update(params: Any, grads: Any, state: dict, cfg: OptConfig,
                 grad_norm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, metrics {grad_norm, lr}).
    ``grad_norm`` is the global norm that clips the gradients, given
    where ``grads`` are one shard of them (a ZeRO update); by default
    the norm of ``grads``."""
    gnorm, scale, step, lr, bc1, bc2 = _update_scalars(grads, state, cfg,
                                                       grad_norm)
    out = [_leaf_update(*leaves, scale, lr, bc1, bc2, cfg) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    rebuild = lambda i: tree_unflatten(params, (o[i] for o in out))
    new_state = {"m": rebuild(1), "v": rebuild(2), "step": step}
    return rebuild(0), new_state, {"grad_norm": gnorm, "lr": lr}


def adamw_update_(params: Any, grads: Any, state: dict, cfg: OptConfig,
                  grad_norm: Optional[torch.Tensor] = None) -> dict:
    """:func:`adamw_update` written into the tensors it reads: every
    parameter, both moments and ``state["step"]`` keep their address (a
    captured train step's standing state, as the reference's jit writes
    its donated state), bitwise the functional update. Returns the
    metrics {grad_norm, lr}."""
    gnorm, scale, step, lr, bc1, bc2 = _update_scalars(grads, state, cfg,
                                                       grad_norm)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        p.copy_(_leaf_update(p, g, m, v, scale, lr, bc1, bc2, cfg,
                             in_place=True)[0])
    state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
