"""Train-step builder: gradient accumulation and AdamW (port of
``repro/train/step.py``).

The step is eager PyTorch: autograd's gradient of the model's loss, then
the functional :func:`~repro_torch.optim.adamw.adamw_update`. With
``cfg.grad_accum > 1`` the batch splits into microbatches run one after
another, so peak activation memory is 1/grad_accum of the full batch;
float32 accumulators sum their losses and gradients, as the reference's
``lax.scan`` does.

The sharding rules (``rules_for``, ``param_shardings``, ``zero_spec``,
``opt_shardings``, ``train_state_shardings``) are the reference's: they
give the PartitionSpec tree of a TrainState on a mesh. On a
``DeviceMesh`` the state lives as DTensors laid out by those specs
(:func:`place_train_state`): parameters by the rule table, AdamW moments
by ``zero_spec`` (ZeRO-1). :func:`build_sharded_train_step` takes this
rank's rows of the batch (split over the data axes), gathers the
parameters whole to compute (the model axis stores shards but computes
replicated), averages the gradients over the data axes, updates each
rank's moment shard and returns the state in the same layout."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (
    AxisRules, DEFAULT_RULES, P, fsdp_rules_for_mesh, is_spec,
    named_sharding_tree, sanitize_specs_tree, spec_placements, specs_for_tree)
from repro_torch.distributed.sharding import tree_map as spec_tree_map
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelAPI, get_api, rules_overrides
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     global_norm, tree_leaves, tree_map,
                                     tree_unflatten)


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


def rules_for(cfg: ModelConfig, mesh) -> AxisRules:
    sizes = C.mesh_shape(mesh)
    if cfg.pure_dp:
        # small-arch strategy: weights REPLICATED over the model axis (which
        # carries sequence parallelism for activations instead); ZeRO shards
        # the embed dim of weight matrices across every mesh axis.
        merged = {k: None for k in DEFAULT_RULES.rules}
        all_axes = tuple(sizes)
        merged["embed"] = all_axes if len(all_axes) > 1 else all_axes[0]
        return AxisRules(merged)
    base = fsdp_rules_for_mesh(mesh) if cfg.use_fsdp else DEFAULT_RULES
    over = rules_overrides(cfg, sizes.get("model", 1))
    merged = dict(base.rules)
    merged.update(over)
    if cfg.use_fsdp:
        # FSDP: additionally shard the embed dim of weight matrices over data
        dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        merged["embed"] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return AxisRules(merged)


def param_shardings(cfg: ModelConfig, mesh, api: Optional[ModelAPI] = None,
                    params_shape: Any = None):
    """The params' PartitionSpec tree. ``params_shape`` is any tree of
    objects with a ``.shape`` (the params themselves will do); without
    it the params are drawn on the CPU to read their shapes."""
    api = api or get_api(cfg)
    spec_tree = specs_for_tree(api.axes(cfg), rules_for(cfg, mesh))
    if params_shape is None:
        params_shape = api.init(cfg, device="cpu")
    return sanitize_specs_tree(spec_tree, params_shape, mesh)


def zero_spec(spec: P, shape: tuple, mesh) -> P:
    """ZeRO-1: extend a param spec with sharding over every UNUSED mesh axis
    on the first still-unsharded, divisible dim — optimizer moments live 1/N
    per device. Falls back to progressively smaller axis subsets when
    divisibility fails (e.g. vocab=50280 shards over data but not 512)."""
    sizes = C.mesh_shape(mesh)
    used = set()
    for s in spec:
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    free = [a for a in sizes if a not in used]
    # try largest subset first, dropping trailing axes on failure
    for cut in range(len(free), 0, -1):
        axes = free[:cut]
        nshard = int(np.prod([sizes[a] for a in axes]))
        if nshard <= 1:
            continue
        new = list(spec)
        for i, s in enumerate(new):
            if s is None and shape[i] % nshard == 0 and shape[i] >= nshard:
                new[i] = tuple(axes) if len(axes) > 1 else axes[0]
                return P(*new)
    return spec


def opt_shardings(param_specs: Any, params_shape: Any, mesh) -> dict:
    m_specs = spec_tree_map(lambda sp, p: zero_spec(sp, tuple(p.shape), mesh),
                            param_specs, params_shape, is_leaf=is_spec)
    return {"m": m_specs, "v": m_specs, "step": P()}


def train_state_shardings(cfg: ModelConfig, mesh, state_shape: "TrainState",
                          api: Optional[ModelAPI] = None) -> "TrainState":
    """PartitionSpec tree matching a TrainState (``state_shape``: the
    state, or any tree of the same structure whose leaves have shapes)."""
    p_specs = param_shardings(cfg, mesh, api, state_shape.params)
    o_specs = opt_shardings(p_specs, state_shape.params, mesh)
    return TrainState(params=p_specs, opt=o_specs, step=P())


def place_train_state(state: "TrainState", specs: "TrainState", mesh):
    """The state as DTensors on ``mesh`` (a ``DeviceMesh``), laid out by
    ``specs``; each rank keeps its own slices of the full leaves."""
    from repro_torch.checkpoint.store import reshard
    return reshard(state, named_sharding_tree(specs, mesh))


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
    grads_of = _loss_and_grads(cfg, api)

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = grads_of(state.params, batch)
        new_params, new_opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, opt_cfg)
        metrics = dict(metrics) if isinstance(metrics, dict) else {"aux": metrics}
        metrics["loss"] = loss
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def _loss_and_grads(cfg, api: ModelAPI) -> Callable:
    """(params, batch) -> (loss, metrics, grads), over ``cfg.grad_accum``
    microbatches run in order (a config without ``grad_accum``, the
    detector's, takes its batch whole)."""
    accum = max(1, getattr(cfg, "grad_accum", 1))

    def loss_fn(params, batch):
        return api.loss_fn(params, cfg, batch)

    def run(params, batch):
        if accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        dev = tree_leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        per_micro = []
        for i in range(accum):
            (li, mi), gi = value_and_grad(
                loss_fn, params, {k: v[i] for k, v in micro.items()})
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
        return loss, metrics, grads

    return run


def data_axes(mesh) -> tuple:
    """The mesh axes a batch splits over: ("pod", "data") where present."""
    return tuple(a for a in ("pod", "data") if a in C.mesh_shape(mesh))


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: dim 0 split over the data axes
    (major to minor), replicated over the rest."""
    ax = data_axes(mesh)
    spec = (ax if len(ax) > 1 else ax[0],) if ax else (None,)
    ctx = C.rank_context(mesh)
    return {k: v[C.local_slices(spec, v.shape, ctx.size, ctx.index)]
            for k, v in batch.items()}


def _mean_over(xs: list, mesh, axes: tuple) -> list:
    """Every tensor of ``xs`` averaged over the mesh axes ``axes``: a SUM
    all-reduce over each axis's group, in place, then one division (gloo
    has no AVG). The backend sums in its own order; the step is held to
    a tolerance, not bitwise."""
    sizes = C.mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    out = []
    for x in xs:
        x = x.detach().contiguous()
        for a in axes:
            dist.all_reduce(x, group=mesh.get_group(a))
        out.append(x / n)
    return out


def build_sharded_train_step(cfg, opt_cfg: OptConfig, mesh, specs: TrainState,
                             api: Optional[ModelAPI] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) on ``mesh`` (a
    ``DeviceMesh``). ``state`` is laid out by ``specs``
    (:func:`place_train_state`); ``batch`` is this rank's rows
    (:func:`local_batch`). Each rank computes the loss and gradients of
    its rows on the whole parameters, the gradients and metrics are
    averaged over the data axes, and AdamW updates this rank's moment
    shards (its ``zero_spec`` slices) with the global gradient norm; the
    new parameters are gathered back into their own layout."""
    from torch.distributed.tensor import DTensor
    api = api or get_api(cfg)
    grads_of = _loss_and_grads(cfg, api)
    axes = data_axes(mesh)
    m_specs = spec_leaves(specs.opt["m"])
    p_place = [spec_placements(sp, mesh) for sp in spec_leaves(specs.params)]
    m_place = [spec_placements(sp, mesh) for sp in m_specs]

    def mine(full, spec):
        ctx = C.rank_context(mesh)
        return full[C.local_slices(spec, full.shape, ctx.size, ctx.index)]

    def train_step(state: TrainState, batch: dict):
        full = tree_map(lambda p: p.full_tensor(), state.params)
        loss, metrics, grads = grads_of(full, batch)
        metrics = dict(metrics) if isinstance(metrics, dict) else {"aux": metrics}
        names = sorted(metrics)
        g_leaves = tree_leaves(grads)
        if axes:
            avg = _mean_over(g_leaves + [loss] + [metrics[k] for k in names],
                             mesh, axes)
            g_leaves, loss = avg[:len(g_leaves)], avg[len(g_leaves)]
            metrics = dict(zip(names, avg[len(g_leaves) + 1:]))
        gnorm = global_norm(g_leaves)
        p_loc = [mine(p, sp) for p, sp in zip(tree_leaves(full), m_specs)]
        g_loc = [mine(g, sp) for g, sp in zip(g_leaves, m_specs)]
        opt_loc = {"m": [m.to_local() for m in tree_leaves(state.opt["m"])],
                   "v": [v.to_local() for v in tree_leaves(state.opt["v"])],
                   "step": state.opt["step"].to_local()}
        new_p, new_opt, opt_metrics = adamw_update(p_loc, g_loc, opt_loc,
                                                   opt_cfg, grad_norm=gnorm)
        as_moment = lambda t, pl: DTensor.from_local(t, mesh, pl,
                                                     run_check=False)
        params = tree_unflatten(state.params, [
            as_moment(p, mp).redistribute(mesh, pp)
            for p, mp, pp in zip(new_p, m_place, p_place)])
        rep = lambda t: DTensor.from_local(t, mesh, state.step.placements,
                                           run_check=False)
        opt = {"m": tree_unflatten(state.opt["m"], [
                   as_moment(m, pl) for m, pl in zip(new_opt["m"], m_place)]),
               "v": tree_unflatten(state.opt["v"], [
                   as_moment(v, pl) for v, pl in zip(new_opt["v"], m_place)]),
               "step": rep(new_opt["step"])}
        metrics["loss"] = loss
        metrics.update(opt_metrics)
        return TrainState(params, opt, rep(state.step.to_local() + 1)), metrics

    return train_step


def spec_leaves(spec_tree: Any) -> list:
    """The PartitionSpecs of a spec tree in :func:`tree_leaves` order
    (dict keys sorted)."""
    if is_spec(spec_tree):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree) for x in spec_leaves(spec_tree[k])]
    return [x for v in spec_tree for x in spec_leaves(v)]
