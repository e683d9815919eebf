"""Train-step builder: gradient accumulation and AdamW (port of
``repro/train/step.py``).

The step is eager PyTorch: autograd's gradient of the model's loss, then
the functional :func:`~repro_torch.optim.adamw.adamw_update`. With
``cfg.grad_accum > 1`` the batch splits into microbatches run one after
another, so peak activation memory is 1/grad_accum of the full batch;
float32 accumulators sum their losses and gradients, as the reference's
``lax.scan`` does. The reference's sharding rules (``rules_for``,
``param_shardings``, ``zero_spec``, ``opt_shardings``,
``train_state_shardings``) wait for the distributed port (ROADMAP.md)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.bridge import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelAPI, get_api
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map, tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt: dict
    step: torch.Tensor


def value_and_grad(loss_fn: Callable, params: Any, *args, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    returns ((loss, aux), grads shaped like params), loss and aux
    detached; a leaf the loss does not reach gets zeros, as ``jax.grad``
    gives."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, live), *args, **kwargs)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    aux = tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x,
                   aux)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def make_train_state(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                     *, device="cuda", api: Optional[ModelAPI] = None
                     ) -> TrainState:
    """Random params from ``gen`` (default seed 0), zero AdamW moments and
    step 0, on ``device`` (the card unless the caller passes "cpu")."""
    api = api or get_api(cfg)
    dev = resolve_device(device)
    params = api.init(cfg, gen, device=dev)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def build_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                     api: Optional[ModelAPI] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves have a leading global-batch dim; with cfg.grad_accum > 1
    the batch splits into microbatches run in order (grad accumulation).
    Metrics are 0-dim tensors: the loss function's own (averaged over
    microbatches), ``loss``, ``grad_norm`` and ``lr``. A config without
    ``grad_accum`` (the detector's) takes its batch whole."""
    api = api or get_api(cfg)
    accum = max(1, getattr(cfg, "grad_accum", 1))

    def loss_fn(params, batch):
        return api.loss_fn(params, cfg, batch)

    def train_step(state: TrainState, batch: dict):
        if accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, state.params,
                                                    batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                     for k, v in batch.items()}
            dev = tree_leaves(state.params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            per_micro = []
            for i in range(accum):
                (li, mi), gi = value_and_grad(
                    loss_fn, state.params, {k: v[i] for k, v in micro.items()})
                loss = loss + li
                for g, h in zip(tree_leaves(grads), tree_leaves(gi)):
                    g.add_(h)                     # the step's own accumulators
                per_micro.append(mi)
                del gi
            loss = loss / accum
            for g in tree_leaves(grads):
                g.div_(accum)
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_micro]))
                       for k in per_micro[0]}

        new_params, new_opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, opt_cfg)
        metrics = dict(metrics) if isinstance(metrics, dict) else {"aux": metrics}
        metrics["loss"] = loss
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
