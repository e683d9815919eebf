"""Train-step builder: gradient accumulation and AdamW (port of
``repro/train/step.py``).

The single-device step (:func:`build_train_step`) is autograd's gradient
of the model's loss, then AdamW written into a standing state, captured
as a CUDA graph on the card as the reference jits its step. With
``cfg.grad_accum > 1`` the batch splits into microbatches run one after
another, so peak activation memory is 1/grad_accum of the full batch;
float32 accumulators sum their losses and gradients, as the reference's
``lax.scan`` does.

The sharding rules (``rules_for``, ``param_shardings``, ``zero_spec``,
``opt_shardings``, ``train_state_shardings``) are the reference's: they
give the PartitionSpec tree of a TrainState on a mesh. On a
``DeviceMesh`` the state lives as DTensors laid out by those specs
(:func:`place_train_state`): parameters by the rule table, AdamW moments
by ``zero_spec`` (ZeRO-1). :func:`train_rank_body` is one rank's step as
a rank body (``distributed.collectives``), the counterpart of the
reference's ``build_train_step`` jitted with those shardings, which XLA
partitions over the mesh: the rank gathers a leaf only over the data
axes where FSDP splits it (and over the model axis where
:func:`model_gathered` says so: the SSD mixer's leaves and a ``pure_dp``
config's), runs the model's ``loss_body`` on its rows under
``act_sharding.tensor_parallel`` (its heads, FFN slice, experts and
vocabulary columns, with the Megatron pair of gradients around each
split product), takes its gradients through every collective, sums them
over the data axes (the FSDP gathers' backward is a reduce-scatter),
takes the global norm with each element counted once and updates its
moment slices. :func:`build_sharded_train_step` runs that body on a
``DeviceMesh`` over DTensor states.

Every gradient path (:func:`value_and_grad`, :class:`TrainStep`,
:func:`grads_rank_body`) runs under :func:`float32_reductions`: the
reference's bf16 products accumulate in float32, and cuBLAS's default
lets a bf16 GEMM sum its split-K partials in bf16."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (
    AxisRules, DEFAULT_RULES, P, fsdp_rules_for_mesh, is_spec,
    named_sharding_tree, sanitize_specs_tree, spec_placements, specs_for_tree)
from repro_torch.distributed.sharding import tree_map as spec_tree_map
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelAPI, get_api, rules_overrides
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     adamw_update_, global_norm, tree_leaves,
                                     tree_map, tree_unflatten)
from repro_torch.utils.graphs import CapturedGraphs


class TrainState(NamedTuple):
    params: Any
    opt: dict
    step: torch.Tensor


_REDUCTIONS = {"depth": 0, "saved": None}


@contextlib.contextmanager
def float32_reductions():
    """Inside the block cuBLAS sums the partial products of a bf16 GEMM
    in float32 (``allow_bf16_reduced_precision_reduction`` off), as the
    reference's dots accumulate; the setting is restored when the
    outermost block ends. Blocks nest, and rank bodies run in turn by
    ``collectives.run_in_process`` interleave theirs: the last to end
    restores it. No effect on the CPU."""
    matmul = torch.backends.cuda.matmul
    if _REDUCTIONS["depth"] == 0:
        _REDUCTIONS["saved"] = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
    _REDUCTIONS["depth"] += 1
    try:
        yield
    finally:
        _REDUCTIONS["depth"] -= 1
        if _REDUCTIONS["depth"] == 0:
            matmul.allow_bf16_reduced_precision_reduction = \
                _REDUCTIONS["saved"]


def value_and_grad(loss_fn: Callable, params: Any, *args, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    returns ((loss, aux), grads shaped like params), loss and aux
    detached; a leaf the loss does not reach gets zeros, as ``jax.grad``
    gives."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad(), float32_reductions():
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


class LossSplit(NamedTuple):
    """A loss split at a host computation, as the reference's
    ``jax.pure_callback`` splits its program: ``device(params, cfg,
    batch) -> (carry, to_host)`` on the device, ``host(array) -> array``
    on the host (numpy in and out), then ``finish(carry, from_host, cfg,
    batch) -> (loss, aux)`` on the device, ``from_host`` being the host
    stage's result as a tensor on the device."""
    device: Callable
    host: Callable
    finish: Callable


def _batch_key(batch: Any) -> tuple:
    """The key a step's graph is replayed under: every batch leaf's shape
    and dtype (the reference's jit retraces on these)."""
    return tuple((tuple(x.shape), x.dtype) for x in tree_leaves(batch))


class TrainStep:
    """``step(state, batch) -> (state, metrics)``: one train step on a
    standing :class:`TrainState` (see :func:`build_train_step`)."""

    def __init__(self, cfg, opt_cfg: OptConfig, api: ModelAPI, *,
                 capture: bool = True):
        self.cfg, self.opt_cfg, self.api = cfg, opt_cfg, api
        self._capture = capture
        self._grads_of = _loss_and_grads(cfg, api)
        self.state: Optional[TrainState] = None   # the standing state
        self.graphs: Optional[CapturedGraphs] = None
        self._batches: dict = {}                  # key -> static batch
        self._host_bufs: dict = {}                # key -> host stage buffers

    def adopt(self, state: TrainState) -> TrainState:
        """The standing state, holding ``state``'s values: at the first
        call a copy of ``state`` (the caller's tensors stay untouched),
        later ``state`` copied into it unless it is the standing state
        itself (a fresh state after a restart in the same process)."""
        leaves = tree_leaves(tuple(state))
        if self.state is None:
            self.graphs = CapturedGraphs(leaves[0].device,
                                         capture=self._capture)
            self.state = TrainState(*tree_map(torch.clone, tuple(state)))
            return self.state
        standing = tree_leaves(tuple(self.state))
        if len(leaves) != len(standing) or any(
                a.shape != b.shape or a.dtype != b.dtype
                or a.device != b.device for a, b in zip(standing, leaves)):
            raise ValueError("a train step's state keeps its structure, "
                             "shapes, dtypes and device from call to call")
        with torch.no_grad():
            for a, b in zip(standing, leaves):
                if a is not b:
                    a.copy_(b)
        return self.state

    def __call__(self, state: TrainState, batch: Any):
        with float32_reductions():
            return self._call(state, batch)

    def _call(self, state: TrainState, batch: Any):
        st = self.adopt(state)
        key = _batch_key(batch)
        static = self._batches.get(key)
        if static is None:
            dev = self.graphs.device
            static = self._batches[key] = tree_map(
                lambda x: torch.empty_like(x, device=dev), batch)
        for a, b in zip(tree_leaves(static), tree_leaves(batch)):
            a.copy_(b)
        split = self.api.loss_split(self.cfg, static) \
            if self.api.loss_split is not None else None
        if split is None:
            out = self.graphs.run("train_step", key,
                                  lambda: self._plain(st, static))
        else:
            out = self.graphs.run_split("train_step", key,
                                        *self._split(st, static, split, key))
        if self.graphs.capture:       # a replay rewrites its static outputs
            out = {k: v.clone() for k, v in out.items()}
        return st, out

    def _update(self, st: TrainState, loss, metrics, grads) -> dict:
        metrics = dict(metrics) if isinstance(metrics, dict) else {"aux": metrics}
        metrics["loss"] = loss
        with torch.no_grad():
            metrics.update(adamw_update_(st.params, grads, st.opt,
                                         self.opt_cfg))
            st.step.add_(1)
        return metrics

    def _plain(self, st: TrainState, batch) -> dict:
        loss, metrics, grads = self._grads_of(st.params, batch)
        return self._update(st, loss, metrics, grads)

    def _split(self, st: TrainState, batch, split: LossSplit, key):
        """The three stages of a split loss: the device stage ends in a
        copy of its host operand into a pinned buffer; the host stage
        writes its result into another; the loss stage copies that to
        the card, takes the gradients through the device stage's
        autograd graph and updates the state."""
        bufs = self._host_bufs.setdefault(key, {})
        dev = self.graphs.device
        pinned = dev.type == "cuda"

        def first():
            live = [p.detach().requires_grad_() for p in tree_leaves(st.params)]
            with torch.enable_grad():
                carry, to_host = split.device(tree_unflatten(st.params, live),
                                              self.cfg, batch)
            if "to_host" not in bufs:
                bufs["to_host"] = torch.empty(to_host.shape,
                                              dtype=to_host.dtype,
                                              pin_memory=pinned)
            bufs["to_host"].copy_(to_host.detach(), non_blocking=True)
            return live, carry

        def host(_):
            out = torch.from_numpy(split.host(bufs["to_host"].numpy()))
            if "from_host" not in bufs:
                bufs["from_host"] = torch.empty(out.shape, dtype=out.dtype,
                                                pin_memory=pinned)
                bufs["on_device"] = torch.empty(out.shape, dtype=out.dtype,
                                                device=dev)
            bufs["from_host"].copy_(out)

        def second(carry):
            live, carry = carry
            from_host = bufs["on_device"].copy_(bufs["from_host"],
                                                non_blocking=True)
            with torch.enable_grad():
                loss, aux = split.finish(carry, from_host, self.cfg, batch)
                # under capture the device stage's autograd graph stays
                # alive: graph B reads its saved tensors at every replay
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            retain_graph=self.graphs.capturing)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(live, grads)]
            aux = tree_map(lambda x: x.detach()
                           if isinstance(x, torch.Tensor) else x, aux)
            return self._update(st, loss.detach(), aux,
                                tree_unflatten(st.params, grads))
        return first, host, second


def build_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                     api: Optional[ModelAPI] = None, *,
                     capture: bool = True) -> TrainStep:
    """Returns ``train_step(state, batch) -> (state, metrics)``, the
    reference's step under ``jax.jit`` with its state donated.

    The step owns a **standing** :class:`TrainState`: params, AdamW
    moments and step counts, each at a fixed address, and a static batch
    for each batch shape. A call copies ``batch`` into the static batch
    (and ``state`` into the standing state unless it is that state; see
    :meth:`TrainStep.adopt`), runs the forward, the loss, its gradients
    and :func:`~repro_torch.optim.adamw.adamw_update_`, which writes the
    state in place, and returns the standing state: a state a caller
    keeps across calls changes under it (clone it to keep it). Metrics
    are 0-dim tensors of the caller's own: the loss function's
    (averaged over microbatches), ``loss``, ``grad_norm`` and ``lr``.

    Batch leaves have a leading global-batch dim; with
    ``cfg.grad_accum > 1`` the batch splits into microbatches run in
    order (gradient accumulation). A config without ``grad_accum`` (the
    detector's) takes its batch whole.

    On the card the step is a CUDA graph keyed by the batch's shapes and
    dtypes (:class:`~repro_torch.utils.graphs.CapturedGraphs`: the first
    call of a key warms up, then captures; later calls replay). A model
    whose ``api.loss_split`` splits the loss at a host stage (the
    detector's Hungarian matcher) is two graphs replayed around it. On
    the CPU, or with ``capture=False`` (the eager oracle), the same
    bodies run eagerly: bitwise the functional step."""
    return TrainStep(cfg, opt_cfg, api or get_api(cfg), capture=capture)


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


#: the axes FSDP splits a parameter over, which a rank gathers it over
DATA_AXES = ("pod", "data")


def model_gathered(cfg: ModelConfig, path: str) -> Optional[str]:
    """Why a rank gathers the parameter leaf at ``path`` over the model
    axis too (None: it computes on its shard)."""
    if getattr(cfg, "pure_dp", False):
        return "pure_dp: ZeRO splits the embed dim over every axis"
    if "/ssd/" in f"/{path}/":
        return ("SSD mixer: in_xbc concatenates x, B and C along the split "
                "dim, so a rank's slice is no block of heads")
    return None


def leaf_paths(tree: Any, prefix: str = "") -> list:
    """The "a/b/c" path of every leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(
            tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaf_paths(
            v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]


def _no_steps(fn: Callable) -> Callable:
    """``fn`` as a rank body step that asks for nothing."""
    def body(*args):
        return fn(*args)
        yield                                      # a generator all the same
    return body


def _owned(spec, ctx: C.RankContext) -> bool:
    """Whether this rank counts a leaf laid out by ``spec`` in a global
    sum: the first rank along every axis the spec does not split it over
    (each element is counted once)."""
    used = {a for e in spec for a in C.spec_axes(e)}
    return all(i == 0 for a, i in ctx.index.items() if a not in used)


def _extra_spec(spec, zspec) -> P:
    """The axes ``zero_spec`` adds to ``spec``, dim by dim."""
    spec = tuple(spec) + (None,) * (len(zspec) - len(spec))
    return P(*[z if s is None else None for s, z in zip(spec, zspec)])


def grads_rank_body(cfg, param_specs: Any,
                    api: Optional[ModelAPI] = None) -> Callable:
    """The gradient half of :func:`train_rank_body`: ``body(ctx, params,
    batch)`` over this rank's slices -> (loss, metrics, grads), the
    gradients in the parameters' layout (each rank's slices of the data
    groups' mean) and the loss and metrics averaged over the data axes.

    Per microbatch (``cfg.grad_accum``, rows taken in order, as the
    reference's scan takes them) the rank gathers each leaf over the
    data axes where FSDP splits it and over the model axis where
    :func:`model_gathered` says so, runs ``api.loss_body`` under
    ``act_sharding.tensor_parallel`` and ``batch_split``, and takes the
    gradients of its loss with respect to its slices (``collectives.grad``:
    through the Megatron pair of the model axis and the gathers, whose
    backward sums the FSDP slices over the data ranks); float32
    accumulators sum the microbatches. The loss is each data group's,
    replicated over the model axis: a slice's gradient is then summed
    over the data axes the leaf is not split over and divided by their
    ranks. A model with no ``loss_body`` computes ``loss_fn`` on leaves
    gathered whole (the DETR train cell's encoder has one:
    ``launch.detr_cells``).

    Under a sequence split (``act_sharding.seq_split``, entered by the
    cell's body) the model ranks compute different token rows, so a
    gradient is the sum of theirs: a leaf's gathers over the model axis
    are not ``replicated`` (backward, the reduce-scatter of the group's
    summed cotangents) and a leaf the spec does not split over the model
    axis sums its gradient over it too. The loss stays the data group's,
    replicated (``common.cross_entropy_body``)."""
    api = api or get_api(cfg)
    accum = max(1, getattr(cfg, "grad_accum", 1))
    p_specs = spec_leaves(param_specs)
    loss_body = api.loss_body or _no_steps(api.loss_fn)

    def body(ctx: C.RankContext, params, batch):
        with float32_reductions():
            return (yield from rank_grads(ctx, params, batch))

    def rank_grads(ctx: C.RankContext, params, batch):
        sizes = ctx.size
        split = acts.seq_split_context()
        replicated = () if split is not None else ("model",)
        paths = leaf_paths(params)
        dp = tuple(a for a in DATA_AXES if sizes.get(a, 1) > 1)
        n_dp = int(np.prod([sizes[a] for a in dp]))
        live = [x.detach().requires_grad_() for x in tree_leaves(params)]
        keeps = [DATA_AXES + (("model",) if api.loss_body is None
                              or model_gathered(cfg, path) else ())
                 for path in paths]
        rows = next(iter(batch.values())).shape[0] // accum
        loss, grads, per_micro = None, None, []
        for i in range(accum):
            mb = batch if accum == 1 else \
                {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            mine = []
            for x, sp, keep in zip(live, p_specs, keeps):
                mine.append((yield from C.gather_dims(
                    x, sp, sizes, keep=keep, replicated=replicated)))
            with acts.tensor_parallel(ctx), acts.batch_split(ctx):
                li, mi = yield from loss_body(tree_unflatten(params, mine),
                                              cfg, mb)
            gi = yield C.grad([li], live)
            li = li.detach()
            if accum == 1:
                loss, grads = li, list(gi)
            else:
                loss = li if loss is None else loss + li
                grads = [g.float() for g in gi] if grads is None else \
                    [a + g for a, g in zip(grads, gi)]
            per_micro.append({k: v.detach() for k, v in (
                mi if isinstance(mi, dict) else {"aux": mi}).items()})
        metrics = per_micro[0]
        if accum > 1:
            loss = loss / accum
            grads = [g / accum for g in grads]
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_micro]))
                       for k in metrics}
        out = []
        for g, sp in zip(grads, p_specs):
            used = {a for e in sp for a in C.spec_axes(e)}
            over = tuple(a for a in dp if a not in used)
            if split is not None and split.axis not in used:
                over += (split.axis,)
            if over:                          # in float32, as AdamW reads it
                g = yield C.psum(over, g.float())
            out.append(g / n_dp if n_dp > 1 else g)
        if dp:
            names = sorted(metrics)
            avg = yield C.pmean(dp, torch.stack(
                [loss.float()] + [metrics[k].float() for k in names]))
            loss = avg[0].to(loss.dtype)
            metrics = {k: avg[j + 1].to(metrics[k].dtype)
                       for j, k in enumerate(names)}
        return loss, metrics, tree_unflatten(params, out)
    return body


def train_rank_body(cfg, opt_cfg: OptConfig, specs: TrainState,
                    api: Optional[ModelAPI] = None) -> Callable:
    """One rank's train step as a rank body ``body(ctx, params, opt,
    step, batch)`` over this rank's slices (``collectives.local_slices``
    of each leaf of ``specs``, the batch's rows split over the data axes
    or whole) -> (params, opt, step, metrics) in the same layout. Run it
    with grad mode on. The gradients are :func:`grads_rank_body`'s; the
    global norm sums each element's square once (:func:`_owned`), and
    AdamW updates the rank's ``zero_spec`` slices, which are gathered
    back into the parameters' layout."""
    grads_of = grads_rank_body(cfg, specs.params, api)
    p_specs = spec_leaves(specs.params)
    extra = [_extra_spec(sp, zs)
             for sp, zs in zip(p_specs, spec_leaves(specs.opt["m"]))]

    def body(ctx: C.RankContext, params, opt, step, batch):
        sizes = ctx.size
        loss, metrics, grads = yield from grads_of(ctx, params, batch)
        grads = tree_leaves(grads)
        sq = sum((torch.sum(torch.square(g.float())) for g, sp
                  in zip(grads, p_specs) if _owned(sp, ctx)),
                 torch.zeros((), dtype=torch.float32, device=loss.device))
        every = tuple(a for a in sizes if sizes[a] > 1)
        if every:
            sq = yield C.psum(every, sq)
        cut = lambda t, ex: t[C.local_slices(ex, t.shape, sizes, ctx.index)]
        with torch.no_grad():
            new_p, new_opt, opt_metrics = adamw_update(
                [cut(x, ex) for x, ex in zip(tree_leaves(params), extra)],
                [cut(g, ex) for g, ex in zip(grads, extra)],
                {"m": tree_leaves(opt["m"]), "v": tree_leaves(opt["v"]),
                 "step": opt["step"]}, opt_cfg, grad_norm=torch.sqrt(sq))
        shards = []
        for x, ex in zip(new_p, extra):
            shards.append((yield from C.gather_dims(x, ex, sizes)))
        metrics = dict(metrics, loss=loss, **opt_metrics)
        new_opt = {"m": tree_unflatten(opt["m"], new_opt["m"]),
                   "v": tree_unflatten(opt["v"], new_opt["v"]),
                   "step": new_opt["step"]}
        return tree_unflatten(params, shards), new_opt, step + 1, metrics
    return body


def build_sharded_train_step(cfg, opt_cfg: OptConfig, mesh, specs: TrainState,
                             api: Optional[ModelAPI] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) on ``mesh`` (a
    ``DeviceMesh``). ``state`` is laid out by ``specs``
    (:func:`place_train_state`); ``batch`` is this rank's rows
    (:func:`local_batch`). The rank's slices run :func:`train_rank_body`
    through ``collectives.run_spmd`` and come back as DTensors of the
    same layout."""
    from torch.distributed.tensor import DTensor
    body = train_rank_body(cfg, opt_cfg, specs, api)
    p_place = [spec_placements(sp, mesh) for sp in spec_leaves(specs.params)]
    m_place = [spec_placements(sp, mesh) for sp in spec_leaves(specs.opt["m"])]

    def train_step(state: TrainState, batch: dict):
        local = lambda t: t.to_local()
        params = tree_map(local, state.params)
        opt = {"m": tree_map(local, state.opt["m"]),
               "v": tree_map(local, state.opt["v"]),
               "step": state.opt["step"].to_local()}
        with torch.enable_grad():
            new_p, new_opt, step, metrics = C.run_spmd(
                body(C.rank_context(mesh), params, opt,
                     state.step.to_local(), batch), mesh)
        wrap = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)
        rep = lambda t: wrap(t, state.step.placements)
        params = tree_unflatten(state.params, [
            wrap(x, pl) for x, pl in zip(tree_leaves(new_p), p_place)])
        opt = {"m": tree_unflatten(state.opt["m"], [
                   wrap(x, pl) for x, pl in zip(tree_leaves(new_opt["m"]),
                                                m_place)]),
               "v": tree_unflatten(state.opt["v"], [
                   wrap(x, pl) for x, pl in zip(tree_leaves(new_opt["v"]),
                                                m_place)]),
               "step": rep(new_opt["step"])}
        return TrainState(params, opt, rep(step)), metrics

    return train_step


def spec_leaves(spec_tree: Any) -> list:
    """The PartitionSpecs of a spec tree in :func:`tree_leaves` order
    (dict keys sorted)."""
    if is_spec(spec_tree):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree) for x in spec_leaves(spec_tree[k])]
    return [x for v in spec_tree for x in spec_leaves(v)]
