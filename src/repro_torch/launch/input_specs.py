"""Per-(arch × shape) dry-run cells (port of
``repro/launch/input_specs.py``).

:func:`build_cell` returns what a dry run needs to trace one cell on a
mesh: the rank program, shape-only inputs (``meta`` tensors of the global
shapes, the counterpart of ``jax.ShapeDtypeStruct``: nothing is
allocated), their PartitionSpecs, and the reference's ``meta``. Kinds:

  train    -> train_step(state, batch)             (fwd+bwd+AdamW update)
  prefill  -> prefill(params, cache, batch)        (forward + cache write)
  decode   -> decode_step(params, cache, tok, pos) (one token vs seq_len cache)

The specs are the reference's: parameters and moments by the port's own
rule table (``train.step.rules_for``, ``train_state_shardings``), the
batch over the data axes, the cache by :func:`_cache_specs`. Under
``jax.jit`` GSPMD partitions the compute by those specs; the port's rank
programs are:

  * ``train``: a rank body (:func:`_train_body`,
    ``train.step.train_rank_body``): forward, loss, backward and AdamW
    on the rank's shards of the model axis and its rows of the batch,
    gathering only what the serving bodies gather (below), the
    gradients through every collective, the vocabulary-parallel loss;
  * ``prefill`` / ``decode``: a rank body (:func:`_serve_body`, a
    generator of ``distributed.collectives``) that computes on its
    shards, as the partitioner splits the reference's: it all-gathers
    only the parameter dims FSDP puts on the data axes, then runs
    ``api.prefill_body`` or ``api.decode_body`` on its rows under
    ``act_sharding.tensor_parallel``: its heads, KV heads, FFN slice,
    experts and vocabulary rows, with the model axis's sums where the
    reference's partitioner reduces (``models/layers.py``). It returns
    its columns of the logits (the vocabulary split over the model axis
    where the rules split it) and writes its own shard of the cache in
    place. At ``long_500k`` (B 1) the reference's ``shard_len`` splits
    the cache's length over the data axis; the decode body keeps it
    split (``act_sharding.cache_split``): the rank that owns the new
    token's slot writes it, each rank runs K5's partial mode over its
    slots, and the ranks' (output, log-sum-exp) rows are gathered and
    merged in rank order, where the partitioner reduces over the split
    dim (no rank holds the cache whole). Two kinds of leaf are
    gathered over the model axis too, each named in
    :func:`model_gathered`: the SSD mixer's (its ``in_xbc`` concatenates
    x, B and C along the split dim, so no rank's slice is a block of
    heads it could compute on) and every leaf of a ``pure_dp`` config
    (ZeRO splits the embed dim over every axis).

Under the ``--opt`` policy (:func:`_maybe_policy`) a ``pure_dp`` config's
train and prefill rank bodies split the sequence over the model axis,
as the reference's ``seq_shard`` pins it: each rank cuts its contiguous
block of its data group's token rows locally (the in-shardings stay the
reference's) and computes only those (``act_sharding.seq_split``);
attention gathers K / V, the SSD scan passes its state from rank to
rank, and the loss is the group's, the model axis's sum of the ranks'
token sums.

``Cell.fn`` takes this rank's tensors (plain tensors: the slices
``distributed.collectives.local_slices`` gives of each global leaf) and
runs on a named ``DeviceMesh``; ``Cell.body``, where the program is one
rank body, also runs every rank of an ``InProcessMesh`` in one process
(``collectives.run_in_process``). A cell built on an ``InProcessMesh``
has its specs and ``meta``; its ``fn`` needs a ``DeviceMesh``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (P, sanitize_specs_tree,
                                              specs_for_tree)
from repro_torch.distributed.sharding import tree_map as spec_tree_map
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import OptConfig, tree_leaves, tree_unflatten
from repro_torch.train.step import (DATA_AXES, TrainState, make_train_state,
                                    model_gathered, rules_for, spec_leaves,
                                    train_rank_body, train_state_shardings)
from repro_torch.utils.tree import tree_map_with_path_str


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable                      # the rank program: fn(*rank_inputs)
    in_specs: Tuple[Any, ...]         # meta tensors of the global shapes
    in_shardings: Tuple[Any, ...]     # PartitionSpec trees
    out_shardings: Any
    meta: dict
    donate: Tuple[int, ...] = ()      # donated args (state / cache): in-place
                                      # updates, as the real launchers run them
    body: Optional[Callable] = None   # the rank body body(ctx, *rank_inputs),
                                      # where the program is one
    computed_whole: Optional[dict] = None  # LM cells: the parameter leaves
                                      # every rank computes whole (see
                                      # computed_whole())


def shape_only(tree: Any) -> Any:
    """A tree's tensors as ``meta`` tensors of the same shape and dtype."""
    return spec_tree_map(
        lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


def traced_shapes(make: Callable[[], Any]) -> Any:
    """What ``make()`` builds, as meta tensors, without allocating it
    (built under a ``FakeTensorMode`` on the CPU: the counterpart of
    ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return shape_only(make())


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in C.mesh_shape(mesh))


def _nshard(mesh, axes: tuple) -> int:
    sizes = C.mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _batch_spec(mesh, b: int) -> P:
    axes = _batch_axes(mesh)
    if b % _nshard(mesh, axes) == 0:
        return P(axes if len(axes) > 1 else axes[0])
    return P(None)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_sds(cfg: ModelConfig, b: int, seq: int, mesh, train: bool):
    """Shape-only tensors + specs for one input batch."""
    bspec = _batch_spec(mesh, b)
    s_tok = seq + 1 if train else seq
    sds = {"tokens": _meta((b, s_tok), torch.int32)}
    sh = {"tokens": bspec}
    if cfg.family == "vlm":
        n_txt = s_tok - cfg.n_img_tokens
        sds["tokens"] = _meta((b, n_txt), torch.int32)
        sds["img_embeds"] = _meta((b, cfg.n_img_tokens, cfg.d_model),
                                  cfg.dtype)
        sh["img_embeds"] = P(*bspec, None, None)
    if cfg.family == "encdec":
        sds["frames"] = _meta((b, cfg.enc_seq_len, cfg.d_model), cfg.dtype)
        sh["frames"] = P(*bspec, None, None)
    return sds, sh


def _cache_specs(cfg: ModelConfig, mesh, b: int, shard_len: bool) -> Callable:
    """PartitionSpec per cache leaf, keyed by leaf name."""
    sizes = C.mesh_shape(mesh)
    bspec = _batch_spec(mesh, b)
    b_axes = bspec[0] if len(bspec) else None
    model_ok = cfg.n_kv_heads % sizes.get("model", 1) == 0
    kv_ax = "model" if model_ok and sizes.get("model", 1) > 1 else None
    len_ax = "data" if shard_len and "data" in sizes else None

    def spec_for(path: str, leaf) -> P:
        name = path.split("/")[-1]
        if name in ("k", "v"):
            return P(None, b_axes, len_ax, kv_ax, None)
        if name == "kpos":
            return P(None, b_axes, len_ax)
        if name in ("mem_k", "mem_v"):
            return P(None, b_axes, None, kv_ax, None)
        if name == "ssm":
            return P(None, b_axes, None, None, None)
        if name == "conv":
            return P(None, b_axes, None, None)
        return P(*([None] * leaf.dim()))
    return spec_for


def _cache_sds_and_shardings(cfg: ModelConfig, mesh, b: int, cache_len: int,
                             shard_len: bool):
    api = get_api(cfg)
    sds = traced_shapes(lambda: api.init_cache(cfg, b, cache_len, device="cpu"))
    specs = tree_map_with_path_str(_cache_specs(cfg, mesh, b, shard_len), sds)
    return sds, specs


def _param_specs(cfg: ModelConfig, mesh, params) -> Any:
    """The serving cells' parameter specs (``params``: any tree of the
    params' shapes)."""
    return sanitize_specs_tree(
        specs_for_tree(get_api(cfg).axes(cfg), rules_for(cfg, mesh)), params,
        mesh)


def serving_program(cfg: ModelConfig, mesh, kind: str, params, cache,
                    shard_len: bool = False):
    """(rank body, parameter specs, cache specs) of a serving cell's rank
    program for a cache of any length: ``params`` and ``cache`` are the
    global trees (or their shapes), ``kind`` "prefill" or "decode"; the
    body takes this rank's slices (``collectives.local_slices``) of the
    params, the cache and the batch (prefill: a batch dict; decode:
    tokens and positions)."""
    b = tree_leaves(cache)[0].shape[1]
    param_specs = _param_specs(cfg, mesh, params)
    cache_specs = tree_map_with_path_str(_cache_specs(cfg, mesh, b, shard_len),
                                         cache)
    body = _serve_body(get_api(cfg), cfg, kind, param_specs, cache_specs)
    return body, param_specs, cache_specs


def _maybe_policy(body: Callable, mesh, policy: bool,
                  cfg: ModelConfig) -> Callable:
    """O1-O4: wrap a cell's rank body so it runs under the
    activation-sharding policy when ``policy`` is set (the --opt dry
    run's cells); baseline runs stay without. The cell's ``fn`` and
    ``body`` are then both under it, whichever runner drives them.
    ``seq_shard`` is ``cfg.pure_dp``, as in the reference. In the port
    the policy moves a train cell's MoE (onto its expert-parallel path,
    where the model axis divides the experts) and, with ``seq_shard``,
    makes a train or prefill cell's rank body split its token rows over
    the model axis (:func:`_train_body`, :func:`_serve_body`;
    ``act_sharding.seq_split``): the split the reference's
    ``constrain_stream`` pins, computed explicitly."""
    if not policy:
        return body
    from repro_torch.distributed.act_sharding import activation_policy
    baxes = _batch_axes(mesh)
    baxes = baxes if len(baxes) > 1 else baxes[0]

    def wrapped(ctx: C.RankContext, *args):
        with activation_policy(mesh, baxes, seq_shard=cfg.pure_dp):
            return (yield from body(ctx, *args))
    return wrapped


# --------------------------------------------------------------------------
# rank programs
# --------------------------------------------------------------------------


def gather_tree(tree: Any, specs: Any, sizes):
    """Rank body step: ``collectives.gather_dims`` over every leaf of
    ``tree`` (leaves in ``tree_leaves`` order)."""
    out = []
    for x, sp in zip(tree_leaves(tree), spec_leaves(specs)):
        out.append((yield from C.gather_dims(x, sp, sizes)))
    return tree_unflatten(tree, out)


def _map_specs(fn: Callable, specs, prefix: str = ""):
    """``fn(path, spec)`` over every leaf of a (dict) spec tree."""
    if isinstance(specs, P):
        return fn(prefix, specs)
    return {k: _map_specs(fn, v, f"{prefix}/{k}" if prefix else k)
            for k, v in specs.items()}


#: the logical axes the rules may put on the model axis
MODEL_SPLIT_AXES = ("heads", "kv_heads", "mlp", "expert", "expert_mlp",
                    "vocab")


def computed_whole(cfg: ModelConfig, param_specs, axes, sizes) -> dict:
    """The parameter leaves every serving rank computes whole on a mesh
    whose model axis has ``sizes["model"]`` > 1 ranks: ``gathered`` (path
    -> why, :func:`model_gathered`: split by the rules, gathered by the
    rank body) and ``replicated`` (leaves with a dim of
    ``MODEL_SPLIT_AXES`` that the rules leave whole on the model axis,
    computed whole on every rank, as XLA computes them). ``axes`` is the
    params' logical-axes tree."""
    out = {"gathered": {}, "replicated": []}

    def see(path, sp):
        logical = axes
        for k in path.split("/"):
            logical = logical[k]
        on_model = any("model" in C.spec_axes(e) for e in sp)
        why = model_gathered(cfg, path)
        if on_model and why:
            out["gathered"][path] = why
        elif not on_model and set(logical) & set(MODEL_SPLIT_AXES):
            out["replicated"].append(path)
    if sizes.get("model", 1) > 1:
        _map_specs(see, param_specs)
    return out


def _gather_specs(cfg: ModelConfig, param_specs) -> Any:
    """Each leaf's spec cut to the axes the serving rank gathers it over:
    the data axes, and the model axis where :func:`model_gathered` says
    so."""
    def cut(path, sp):
        keep = DATA_AXES + (("model",) if model_gathered(cfg, path) else ())
        return P(*[tuple(a for a in C.spec_axes(e) if a in keep) or None
                   for e in sp])
    return _map_specs(cut, param_specs)


def _length_axes(cache_specs) -> tuple:
    """The mesh axes the KV cache's length (dim 2 of ``k``) lies split
    over: the reference's ``shard_len`` puts it on the data axis."""
    found = []
    _map_specs(lambda path, sp: found.append(C.spec_axes(sp[2]))
               if path.split("/")[-1] == "k" else None, cache_specs)
    return found[0] if found else ()


def _cut_tokens(cfg: ModelConfig, batch: dict, split, extra: int) -> dict:
    """The batch with the rank's block of token rows of a sequence split
    (``extra`` rows more after it: the shifted labels of a train batch),
    cut locally: the cell's in-shardings stay the reference's (batch over
    the data axes only). Other leaves (whisper's frames) stay whole."""
    if cfg.family == "vlm":
        raise ValueError(f"{cfg.name}: a sequence split cuts token rows, and "
                         "a vlm stream starts with image embeddings")
    return dict(batch, tokens=split.cut(batch["tokens"], 1, extra))


def _serve_body(api, cfg: ModelConfig, kind: str, param_specs, cache_specs):
    """The rank body of a prefill or decode cell: args (params, cache,
    batch dict) for prefill, (params, cache, tokens, pos) for decode.
    Returns (this rank's logits, its cache shard, written in place).
    Under a policy with ``seq_shard`` a prefill rank computes its block
    of the prompt's rows (``act_sharding.seq_split``) and returns the
    last position's logits, as every rank of the reference's replicated
    output holds them."""
    gather_specs = _gather_specs(cfg, param_specs)
    length_axes = _length_axes(cache_specs)
    if length_axes and kind == "prefill":
        raise ValueError(f"{cfg.name}: a prefill writes its prompt's slots "
                         "whole; the cache's length may lie split over "
                         f"{length_axes} only in a decode cell")

    def body(ctx: C.RankContext, params, cache, *rest):
        mine = yield from gather_tree(params, gather_specs, ctx.size)
        with acts.tensor_parallel(ctx), acts.cache_split(ctx, length_axes):
            if kind == "prefill":
                batch = rest[0]
                with acts.seq_split(ctx, batch["tokens"].shape[1]) as split:
                    if split is not None:
                        batch = _cut_tokens(cfg, batch, split, 0)
                    logits, _ = yield from api.prefill_body(mine, cfg, cache,
                                                            batch)
            else:
                logits, _ = yield from api.decode_body(mine, cfg, cache,
                                                       *rest)
        return logits, cache
    return body


def logits_spec(cfg: ModelConfig, mesh, b: int) -> P:
    """How a serving cell's ranks hold the (B, V) logits they return:
    rows as the batch, columns as the rules split the vocabulary (the
    head's columns)."""
    return P(*_batch_spec(mesh, b), rules_for(cfg, mesh).physical("vocab"))


def spmd_program(body: Callable, mesh) -> Callable:
    """``fn(*rank_inputs)``: ``body`` run on this process's rank of
    ``mesh`` (a ``DeviceMesh``) by ``collectives.run_spmd``."""
    def fn(*args):
        return C.run_spmd(body(C.rank_context(mesh), *args), mesh)
    return fn


def _train_body(cfg: ModelConfig, opt_cfg: OptConfig, specs: TrainState,
                api=None) -> Callable:
    """The rank body of a train cell: args (state, batch), this rank's
    slices of each; returns (its slices of the new state, metrics)
    (``train.step.train_rank_body``). Under a policy with ``seq_shard``
    the rank takes its block of the input rows ``tokens[:, :-1]`` and of
    their labels (``act_sharding.seq_split``)."""
    step = train_rank_body(cfg, opt_cfg, specs, api)

    def body(ctx: C.RankContext, state: TrainState, batch: dict):
        with acts.seq_split(ctx, batch["tokens"].shape[1] - 1) as split:
            if split is not None:
                batch = _cut_tokens(cfg, batch, split, 1)
            params, opt, n, metrics = yield from step(
                ctx, state.params, state.opt, state.step, batch)
        return TrainState(params, opt, n), metrics
    return body


def _train_program(body: Callable, mesh) -> Callable:
    """``fn(*rank_inputs)`` (a train cell's: state and batch) on this
    rank's slices of ``mesh`` (a ``DeviceMesh``): the train body under
    grad mode."""
    run = spmd_program(body, mesh)

    def fn(*args):
        with torch.enable_grad():
            return run(*args)
    return fn


def build_cell(arch: str, cfg: ModelConfig, shape: ShapeSpec, mesh,
               opt_cfg: Optional[OptConfig] = None,
               policy: bool = False) -> Cell:
    api = get_api(cfg)
    sizes = C.mesh_shape(mesh)
    b, seq = shape.global_batch, shape.seq_len
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "seq_len": seq, "global_batch": b,
            "mesh": dict(sizes), "n_chips": _nshard(mesh, tuple(sizes)),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig()
        state_sds = traced_shapes(lambda: make_train_state(cfg, device="cpu"))
        state_specs = train_state_shardings(cfg, mesh, state_sds)
        batch_sds, batch_sh = _batch_sds(cfg, b, seq, mesh, train=True)
        body = _maybe_policy(_train_body(cfg, opt_cfg, state_specs, api),
                             mesh, policy, cfg)
        return Cell(name=f"{arch}/{shape.name}",
                    fn=_train_program(body, mesh),
                    in_specs=(state_sds, batch_sds),
                    in_shardings=(state_specs, batch_sh),
                    out_shardings=(state_specs, None), meta=meta, donate=(0,),
                    body=body, computed_whole=computed_whole(
                        cfg, state_specs.params, api.axes(cfg), sizes))

    # serving cells share param shardings (no optimizer)
    params_sds = traced_shapes(lambda: api.init(cfg, device="cpu"))
    param_specs = _param_specs(cfg, mesh, params_sds)
    whole = computed_whole(cfg, param_specs, api.axes(cfg), sizes)

    if shape.kind == "prefill":
        cache_sds, cache_sh = _cache_sds_and_shardings(
            cfg, mesh, b, cache_len=seq, shard_len=False)
        batch_sds, batch_sh = _batch_sds(cfg, b, seq, mesh, train=False)
        body = _maybe_policy(_serve_body(api, cfg, "prefill", param_specs,
                                         cache_sh), mesh, policy, cfg)
        return Cell(name=f"{arch}/{shape.name}",
                    fn=spmd_program(body, mesh),
                    in_specs=(params_sds, cache_sds, batch_sds),
                    in_shardings=(param_specs, cache_sh, batch_sh),
                    out_shardings=(None, cache_sh), meta=meta, donate=(1,),
                    body=body, computed_whole=whole)

    assert shape.kind == "decode"
    shard_len = b == 1                    # SP: long-context shards the cache
    cache_sds, cache_sh = _cache_sds_and_shardings(
        cfg, mesh, b, cache_len=seq, shard_len=shard_len)
    bspec = _batch_spec(mesh, b)
    tok_sds = _meta((b,), torch.int32)
    pos_sds = _meta((b,), torch.int32)
    body = _maybe_policy(_serve_body(api, cfg, "decode", param_specs,
                                     cache_sh), mesh, policy, cfg)
    return Cell(name=f"{arch}/{shape.name}",
                fn=spmd_program(body, mesh),
                in_specs=(params_sds, cache_sds, tok_sds, pos_sds),
                in_shardings=(param_specs, cache_sh, bspec, bspec),
                out_shardings=(None, cache_sh), meta=meta, donate=(1,),
                body=body, computed_whole=whole)
